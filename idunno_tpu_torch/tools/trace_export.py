"""Chrome/Perfetto trace-event export for the port's span dumps.

The port's counterpart of ``tools/trace_export.py``. It converts the span
lists of ``utils/spans.py`` (a node's ``spans_dump`` window, the
cluster-merged ``trace`` verb reply, or a chaos ``last_span_dump``) into
Chrome trace-event JSON, loadable in ui.perfetto.dev or chrome://tracing
with one process lane per node, and back. The mapping is lossless: spans
become ``ph:"X"`` complete events (µs timestamps rebased to the trace
start, the absolute base in ``otherData.t_base``), still-open spans
``ph:"i"`` instants, span, parent and trace ids ride in ``args`` beside
the attrs, and node names in ``process_name`` metadata events.
``from_chrome`` inverts all of it. ``to_chrome``, ``from_chrome``,
``waterfall`` and ``selftest`` are the JAX tool's, apart from their
import lines.

    python -m idunno_tpu_torch.tools.trace_export --selftest
    python -m idunno_tpu_torch.tools.trace_export --in reply.json \
        --out perfetto.json
    python -m idunno_tpu_torch.tools.trace_export --capture

``--capture`` runs one traced request through the port's ``DecodeServer``
(a paged pool: every decode step attends through K3 on the card) behind
an ``LMServingLoop`` and writes the waterfall, the Perfetto document, the
kernels' launches and the provenance, to
``chiprun_out/trace_waterfall_torch.json`` unless ``--out`` says
otherwise. Every mode prints one JSON line and runs where a card is
present, or with ``--cpu``.
"""
from __future__ import annotations

import json
import sys
import time

_RESERVED = ("trace_id", "span_id", "parent")


def to_chrome(spans: list[dict], trace_id: str | None = None) -> dict:
    """Span wire dicts -> Chrome trace-event document (one pid per node)."""
    spans = [dict(s) for s in spans
             if trace_id is None or s["trace_id"] == trace_id]
    base = min((s["t_start"] for s in spans), default=0.0)
    nodes = sorted({s["node"] for s in spans})
    pid = {n: i + 1 for i, n in enumerate(nodes)}
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid[n], "tid": 0,
         "args": {"name": n}} for n in nodes]
    for s in spans:
        args = {"trace_id": s["trace_id"], "span_id": s["span_id"]}
        if s.get("parent") is not None:
            args["parent"] = s["parent"]
        args.update(s.get("attrs") or {})
        ev = {"name": s["name"], "cat": "span", "pid": pid[s["node"]],
              "tid": 0, "ts": round((s["t_start"] - base) * 1e6, 3),
              "args": args}
        if s.get("t_end") is None:           # still-open span: instant
            ev.update(ph="i", s="t")
        else:
            ev.update(ph="X",
                      dur=round((s["t_end"] - s["t_start"]) * 1e6, 3))
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"t_base": base}}


def from_chrome(doc: dict) -> list[dict]:
    """Chrome trace-event document -> span wire dicts (inverse of
    `to_chrome`, exact for documents it produced)."""
    base = float((doc.get("otherData") or {}).get("t_base", 0.0))
    names = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    out = []
    for e in doc["traceEvents"]:
        if e.get("cat") != "span":
            continue
        args = dict(e.get("args") or {})
        tid = args.pop("trace_id")
        sid = args.pop("span_id")
        parent = args.pop("parent", None)
        t0 = round(base + e["ts"] / 1e6, 6)
        out.append({"trace_id": tid, "span_id": sid, "parent": parent,
                    "name": e["name"], "node": names.get(e["pid"], "?"),
                    "t_start": t0,
                    "t_end": (round(t0 + e["dur"] / 1e6, 6)
                              if e.get("ph") == "X" else None),
                    "attrs": args})
    return out


def waterfall(trace_id: str, spans: list[dict]) -> dict:
    """ONE-JSON-line waterfall of a trace: rows sorted by start offset,
    durations in ms — the machine-readable twin of the shell's `trace`
    command output."""
    spans = sorted((s for s in spans if s["trace_id"] == trace_id),
                   key=lambda s: (s["t_start"], s["span_id"]))
    base = min((s["t_start"] for s in spans), default=0.0)
    end = max((s["t_end"] for s in spans if s.get("t_end") is not None),
              default=base)
    rows = [{"name": s["name"], "node": s["node"],
             "offset_ms": round((s["t_start"] - base) * 1000.0, 3),
             "ms": (round((s["t_end"] - s["t_start"]) * 1000.0, 3)
                    if s.get("t_end") is not None else None),
             "parent": s.get("parent"),
             "attrs": s.get("attrs") or {}} for s in spans]
    return {"trace_id": trace_id, "spans": len(rows),
            "nodes": sorted({s["node"] for s in spans}),
            "duration_ms": round((end - base) * 1000.0, 3),
            "rows": rows}


def selftest() -> dict:
    """Synthetic two-node trace -> Perfetto doc -> back; asserts the
    round-trip reproduces every span exactly (fast lane, no jax)."""
    from idunno_tpu_torch.utils.spans import SpanStore

    clk = {"t": 100.0}
    a = SpanStore("node-a", clock=lambda: clk["t"])
    b = SpanStore("node-b", clock=lambda: clk["t"])
    root = a.start("client.op", attrs={"kind": "selftest"})
    clk["t"] += 0.005
    child = b.start("server.handle", trace=root.trace_id,
                    parent=root.span_id, attrs={"hop": 1})
    clk["t"] += 0.010
    b.record("server.step", trace=root.trace_id, parent=child.span_id,
             attrs={"i": 0})
    clk["t"] += 0.002
    b.finish(child, rows=3)
    clk["t"] += 0.001
    a.finish(root, ok=True)
    spans = a.dump() + b.dump()
    # a still-open span exercises the instant-event path
    spans.append({"trace_id": root.trace_id, "span_id": "node-a:99",
                  "parent": root.span_id, "name": "still.open",
                  "node": "node-a", "t_start": round(clk["t"], 6),
                  "t_end": None, "attrs": {}})
    doc = to_chrome(spans, trace_id=root.trace_id)
    back = from_chrome(doc)
    key = lambda s: s["span_id"]  # noqa: E731
    assert sorted(back, key=key) == sorted(spans, key=key), \
        "round-trip mismatch"
    wf = waterfall(root.trace_id, spans)
    assert wf["spans"] == len(spans) and wf["nodes"] == ["node-a", "node-b"]
    return {"selftest": "ok", "spans": len(spans),
            "events": len(doc["traceEvents"]),
            "duration_ms": wf["duration_ms"]}


# the captured pool: head_dim 64, so the paged decode runs K3 on the card
CAPTURE_MODEL = {"vocab": 128, "dim": 256, "depth": 2, "num_heads": 4}
CAPTURE_POOL = {"slots": 4, "prompt_len": 16, "max_len": 48,
                "kv_block_size": 16, "paged_kernel": "auto"}


def capture(out_path: str, dev, max_new: int = 16) -> dict:
    """One traced request through a paged ``DecodeServer`` behind an
    ``LMServingLoop`` on ``dev``; writes the waterfall, the Perfetto
    document, the kernels' launches (zeroed just before the request) and
    the provenance to ``out_path`` and returns the summary."""
    import random

    import torch

    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.models.init import init_like_flax
    from idunno_tpu_torch.models.transformer import TransformerLM
    from idunno_tpu_torch.ops.launches import read_launches, zero_launches
    from idunno_tpu_torch.serve.lm_pool import LMServingLoop
    from idunno_tpu_torch.tools import stamp, write
    from idunno_tpu_torch.utils.spans import SpanStore

    store = SpanStore("bench")
    model = TransformerLM(**CAPTURE_MODEL, causal=True)
    init_like_flax(model, torch.Generator().manual_seed(0))
    server = DecodeServer(model, device=dev, **CAPTURE_POOL)
    server.warmup()      # the kernels' build paid off the trace
    loop = LMServingLoop(server, name="trace-capture", spans=store)
    rng = random.Random(0)
    zero_launches()
    root = store.start("lm.submit", attrs={"pool": "trace-capture"})
    rid = loop.submit([rng.randrange(1, CAPTURE_MODEL["vocab"])
                       for _ in range(CAPTURE_POOL["prompt_len"])],
                      max_new, trace=root.ctx)
    done = {}
    deadline = time.monotonic() + 120.0
    while rid not in done and time.monotonic() < deadline:
        for c in loop.poll():
            done[c.id] = c
        time.sleep(0.002)
    store.finish(root, rid=rid)
    loop.stop()
    launches = read_launches()
    if rid not in done:
        raise RuntimeError("the traced request never completed")
    spans = store.dump(trace_id=root.trace_id)
    wf = waterfall(root.trace_id, spans)
    rec = stamp({"decode_steps": sum(1 for s in spans
                                     if s["name"] == "lm.decode_step"),
                 "tokens": len(done[rid].tokens), "launches": launches,
                 "waterfall": wf,
                 "chrome": to_chrome(spans, trace_id=root.trace_id)}, dev)
    if dev.type == "cpu":
        del rec["launches"]          # the plain versions count nothing
    write(rec, out_path)
    return {"captured": out_path, "device": rec["device"],
            "trace_id": wf["trace_id"], "spans": wf["spans"],
            "decode_steps": rec["decode_steps"],
            "duration_ms": wf["duration_ms"],
            **({"launches": launches} if dev.type == "cuda" else {})}


def main(argv: list[str] | None = None) -> int:
    from idunno_tpu_torch.tools import default_out, device, parser, stamp

    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--capture", action="store_true")
    ap.add_argument("--in", dest="inp",
                    help="JSON file: a `trace` verb reply "
                         "({trace_id, spans}) or a bare span list")
    ap.add_argument("--out", default=None,
                    help="output path (--capture's record, default "
                         "chiprun_out/trace_waterfall_torch.json; --in's "
                         "Perfetto document, default perfetto.json)")
    args = ap.parse_args(argv)
    if not (args.selftest or args.capture or args.inp):
        ap.error("pass --selftest, --capture, or --in FILE")
    dev = device(args.cpu)
    if dev is None:
        return 2
    if args.selftest:
        print(json.dumps(stamp(selftest(), dev)))
    elif args.capture:
        print(json.dumps(capture(
            args.out or default_out("trace_waterfall_torch.json"), dev)))
    else:
        with open(args.inp) as f:
            data = json.load(f)
        spans = data["spans"] if isinstance(data, dict) else data
        tid = data.get("trace_id") if isinstance(data, dict) else None
        doc = to_chrome(spans, trace_id=tid)
        out = args.out or "perfetto.json"
        with open(out, "w") as f:
            json.dump(doc, f, indent=1)
        print(json.dumps(stamp({"wrote": out,
                                "events": len(doc["traceEvents"])}, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
