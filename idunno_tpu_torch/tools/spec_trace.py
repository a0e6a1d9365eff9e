"""Trace one speculative decode dispatch against one plain dispatch.

The port's counterpart of ``tools/spec_trace.py``. Both pools are the
port's ``DecodeServer`` over a paged block pool (``paged_pool_kw``: every
decode step and every verify chunk attends through K3 on the card) at
``utils/lm_bench.py:lm_bench_config``, the speculative one with the
bench's draft (dim 256, depth 2, 4 heads on the card) proposing
``draft_len`` tokens a round. Both trees are zeroed, the bench's
constructed full-acceptance pair: every logit ties, so every round
commits the whole chunk (``draft_len + 1`` tokens a row) and the traced
dispatch is the mechanism's ceiling, not a study of rejections. Each pool
is warmed, every slot loaded, one dispatch run, and one more traced with
``utils/tracing.py:trace`` and apportioned by ``tools/parse_trace.py``
(device time by kernel and class, idle gaps), beside the tokens each live
row committed in it and, on the card, the kernels' launches.

    python -m idunno_tpu_torch.tools.spec_trace            # the card
    python -m idunno_tpu_torch.tools.spec_trace --cpu      # the machinery

The record goes to ``chiprun_out/spec_trace_torch.json`` and the traces
under ``chiprun_out/spec_trace_torch/`` unless ``--out`` says otherwise.
On the CPU (the bench's miniature, depth 2) nothing is traced, and the
record holds no device time and no launches.
"""
from __future__ import annotations

import os
import sys
import time


def traced_dispatch(srv, cfg: dict, trace_dir: str | None,
                    max_new: int) -> dict:
    """Warm ``srv``, load every slot, run one dispatch, then one more
    (under ``trace(trace_dir)`` unless it is None): its wall seconds, the
    tokens each live row committed in it, the launches (card) and the
    apportioned trace."""
    import torch

    from idunno_tpu_torch.ops.launches import read_launches, zero_launches
    from idunno_tpu_torch.tools.parse_trace import apportion
    from idunno_tpu_torch.utils.tracing import trace

    srv.warmup()
    for _ in range(cfg["slots"]):
        srv.submit(list(range(1, cfg["prompt_len"] + 1)), max_new=max_new)
    srv.step()                                   # admissions + a dispatch
    card = srv.device.type == "cuda"
    cur0 = srv._cursors.cpu().clone()
    if card:
        torch.cuda.synchronize()
        zero_launches()
    t0 = time.perf_counter()
    if trace_dir is None:
        srv.step()
    else:
        with trace(trace_dir):
            srv.step()
            srv._cursors.cpu()                   # waits for the dispatch
    wall = time.perf_counter() - t0
    per_row = (srv._cursors.cpu() - cur0).tolist()
    out = {"wall_s": wall, "tokens_per_row": per_row,
           "dispatches": srv.graph_stats()}
    if card:
        out["launches"] = read_launches()
    if trace_dir is not None:
        rep = apportion(trace_dir, top=20)
        out["apportion"] = {k: rep[k] for k in (
            "source", "device_total_ms", "classes", "kernel_counts",
            "window_ms", "idle_ms", "gap_count", "ops")}
        out["apportion"]["gaps"] = rep["gaps"][:10]
    srv.run_until_drained()
    return out


def run(dev, out_dir: str | None, cfg: dict | None = None) -> dict:
    """The two traced dispatches on ``dev`` (traces under ``out_dir``,
    none where it is None); returns the record without provenance."""
    import torch

    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.utils.lm_bench import (_block_size, build_lm,
                                                 lm_bench_config,
                                                 paged_pool_kw, spec_max_new,
                                                 spec_rounds)

    platform = "cuda" if dev.type == "cuda" else "cpu"
    cfg = cfg or lm_bench_config(platform)
    dtype = torch.bfloat16 if platform == "cuda" else torch.float32
    target = build_lm(cfg, dev, 0, zero=True, dtype=dtype)
    draft = build_lm(cfg, dev, 1, dim=cfg["draft_dim"],
                     depth=cfg["draft_depth"],
                     heads=max(1, cfg["heads"] // 4), zero=True, dtype=dtype)
    gamma = cfg["draft_len"]
    rounds = spec_rounds(cfg)
    pool = dict(slots=cfg["slots"], prompt_len=cfg["prompt_len"],
                max_len=cfg["max_len"], device=dev,
                **paged_pool_kw(_block_size(platform), cfg["slots"],
                                cfg["prompt_len"]))
    rec: dict = {"config": {k: cfg[k] for k in (
                     "dim", "depth", "heads", "vocab", "slots", "prompt_len",
                     "max_len", "decode_steps", "draft_dim", "draft_depth",
                     "draft_len")},
                 "rounds_per_dispatch": rounds}

    def where(name):
        return None if out_dir is None else os.path.join(out_dir, name)

    plain = DecodeServer(target, decode_steps=cfg["decode_steps"], **pool)
    rec["plain"] = traced_dispatch(plain, cfg, where("plain"),
                                   spec_max_new(cfg))
    rec["plain"]["steps"] = cfg["decode_steps"]
    rec["plain"]["wall_ms_per_step"] = (1e3 * rec["plain"]["wall_s"]
                                        / cfg["decode_steps"])
    del plain
    spec = DecodeServer(target, draft=(draft, None), draft_len=gamma,
                        decode_steps=rounds, **pool)
    rec["spec"] = traced_dispatch(spec, cfg, where("spec"),
                                  spec_max_new(cfg))
    rec["spec"]["rounds"] = rounds
    rec["spec"]["wall_ms_per_round"] = 1e3 * rec["spec"]["wall_s"] / rounds
    del spec
    rec["every_round_commits_the_chunk"] = all(
        n == rounds * (gamma + 1) for n in rec["spec"]["tokens_per_row"])
    for key, n in (("plain", cfg["decode_steps"]), ("spec", rounds)):
        if "apportion" in rec[key]:
            rec[key]["apportion"]["per_step_ms"] = (
                rec[key]["apportion"]["device_total_ms"] / n)
    return rec


def main(argv: list[str] | None = None) -> int:
    import json

    from idunno_tpu_torch.tools import device, parser, stamp, write

    ap = parser(__doc__.splitlines()[0], out="spec_trace_torch.json")
    args = ap.parse_args(argv)
    dev = device(args.cpu)
    if dev is None:
        return 2
    out_dir = (None if dev.type == "cpu"
               else os.path.splitext(args.out)[0])
    rec = stamp(run(dev, out_dir), dev)
    write(rec, args.out)
    print(json.dumps({k: rec[k] for k in (
        "device", "rounds_per_dispatch", "every_round_commits_the_chunk")}
        | {k: {f: rec[k][f] for f in ("wall_s", "tokens_per_row")}
           for k in ("plain", "spec")}))
    return 0 if rec["every_round_commits_the_chunk"] else 1


if __name__ == "__main__":
    sys.exit(main())
