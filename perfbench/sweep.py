"""Find the knee of an open-loop serving cell: the highest offered rate at
which the requests completed over a window keep within 5% of those offered
in it, and the backlog at its close (offered, not completed) is no more
than the pool's slots.

    python3 -m perfbench.sweep --workload <cell> --seed <n> --seconds <s>
        --lead <s> --rates 6,8,10 [--out chiprun_out/sweep.json]

Each rate offers its traffic for ``--lead`` seconds before the window, so
that the window sees the pool in its steady state; completions in the
window count whichever request they finish. One pool serves every rate
in turn, drained between rates; each rate draws its own requests from the
seed. Prints one JSON line a rate. The knee is written into the mix's file
by hand, as a number.
"""
from __future__ import annotations

import argparse
import json
import math

import torch

from perfbench import harness, spec, traffic
from perfbench.drivers import lm_common, lm_open_loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--lead", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    device = torch.device("cuda", 0)
    pool = cell.traffic["pool"]
    srv = lm_common.build_pool(
        lm_common.build_model(cell, args.seed, device), pool, device)
    lm_open_loop.warm(srv, cell, args.seed)
    rows = []
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        span = args.lead + args.seconds
        _, reqs = lm_open_loop.schedule(cell, args.seed + k, span,
                                        rate=rate)
        win = harness.Window(span, {"seconds": 0.0}, False, True)
        s = lm_open_loop.serve(srv, reqs, win, 0.0, 0.0)
        lo, hi = s["t0"] + args.lead, s["t0"] + span
        offered = sum(1 for r in reqs if r[0] >= args.lead)
        completed = sum(1 for seen, _ in s["done"].values() if lo <= seen <= hi)
        measured = [i for i in range(len(reqs)) if reqs[i][0] >= args.lead]
        ttft = sorted(s["first"].get(i, math.inf) - (s["t0"] + reqs[i][0])
                      for i in measured)
        row = {"rate_per_s": rate, "offered": offered, "completed": completed,
               "completed_share": completed / max(1, offered),
               "backlog": len(reqs) - s["completed_at_close"],
               "slots": pool["slots"],
               "ttft_p50_ms": traffic.percentile(ttft, 50) * 1e3,
               "ttft_p95_ms": traffic.percentile(ttft, 95) * 1e3,
               "generator_late_s": s["late"]}
        row["sustained"] = (row["completed_share"] >= 0.95
                            and row["backlog"] <= pool["slots"])
        rows.append(row)
        print(json.dumps(row), flush=True)
        srv.run_until_drained(max_steps=1_000_000)
    knee = max((r["rate_per_s"] for r in rows if r["sustained"]), default=None)
    print(json.dumps({"knee_per_s": knee}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "knee_per_s": knee}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
