"""Readings from which a cell's limits are set: the program's numbers over
many seeds, and those of the control (the fp8 reference in the program's
place) and of the planted faults, in one process.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3
        --seconds <s> [--out chiprun_out/control.json]

Each seed is a whole run of the cell at its own size with a short window
(long enough to finish the mix's longest requests), checked with the
control on; one JSON line a seed. The summary gives, for each number, the
largest program reading and the smallest control and fault readings.
"""
from __future__ import annotations

import argparse
import importlib
import json
import time

import torch

from perfbench import harness, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    device = torch.device("cuda", 0)
    driver = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}")
    torch.zeros(1, device=device)       # the peak resets once CUDA is up
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats(device)
        t = time.monotonic()
        out = driver.run(cell, seed, args.seconds, False, device,
                         control=True)
        row = {"seed": seed, "readings": out.readings,
               "end_to_end": out.end_to_end, "attempted": out.attempted,
               "failed": out.failed, "memory_peak_bytes":
               out.memory_peak_bytes, "seconds": time.monotonic() - t,
               "setup_s": out.counters["window_start"] - t}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out
        harness.free_device(device)
    summary = {}
    for key in rows[0]["readings"]:
        vals = [r["readings"][key] for r in rows]
        summary[key] = max(vals) if "." not in key else min(vals)
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
