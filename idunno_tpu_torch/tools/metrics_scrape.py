"""Prometheus scrape client for the ``metrics_export`` control verb.

The port's counterpart of ``tools/metrics_scrape.py``: connect to a
running port node's control service (``comm/net.py:oneshot_call``, no
listener needed), ask for its Prometheus text exposition
(``serve/metrics.py:prometheus_text``: the tracker's counters, rates,
percentiles and gauges, the LM pools' gauges, ``comm/retry.py``'s retry
counters and the span store's depth; ``serve/control.py`` answers it),
and print it in one JSON line.

    python -m idunno_tpu_torch.tools.metrics_scrape --ip 10.0.0.2 \
        --port 9400
    python -m idunno_tpu_torch.tools.metrics_scrape --selftest

``--selftest`` builds a ``MetricsTracker`` and a ``SpanStore`` in process,
renders the exposition and asserts its format (every series line matches
``name{labels} value``, one ``# TYPE`` a metric, the extra counters and
gauges land). ``scrape``, ``selftest`` and ``_SERIES`` are the JAX tool's,
apart from their import lines. It runs where a card is present, or with
``--cpu``, as every tool of this package does.
"""
from __future__ import annotations

import json
import re
import sys

_SERIES = re.compile(r'^[a-z_]+\{[^}]*\} -?[0-9.e+-]+$')


def scrape(ip: str, port: int, timeout: float = 10.0) -> str:
    from idunno_tpu_torch.comm.message import Message
    from idunno_tpu_torch.comm.net import oneshot_call
    from idunno_tpu_torch.utils.types import MessageType

    out = oneshot_call(ip, port, "control",
                       Message(MessageType.INFERENCE, "metrics-scrape",
                               {"verb": "metrics_export"}),
                       timeout=timeout)
    if out is None or out.type is not MessageType.ACK:
        raise RuntimeError(f"scrape failed: {out and out.payload}")
    return out.payload["text"]


def selftest() -> dict:
    from idunno_tpu_torch.serve.metrics import MetricsTracker
    from idunno_tpu_torch.utils.spans import SpanStore

    clk = {"t": 50.0}
    m = MetricsTracker(clock=lambda: clk["t"])
    m.record_counter("stale_epoch_rejected", 3)
    m.record_counter("gateway_shed_quota", 2)
    m.record_task("resnet18", 100, 1.5, 100)
    m.record_query_done("resnet18")
    m.record_lm_gauges("pool", {"prefix_hit_rate": 0.5, "note": "str-skip"})
    m.record_gateway_gauges("pool", {"queued": 4})
    spans = SpanStore("n0", clock=lambda: clk["t"])
    spans.record("x")
    text = m.prometheus_text(
        "n0", extra_counters={"retry_attempts": 7},
        extra_gauges={"span_buffer_depth": spans.depth(),
                      "spans_recorded_total": spans.recorded_total()})
    lines = text.strip().split("\n")
    series = [ln for ln in lines if not ln.startswith("# TYPE")]
    bad = [ln for ln in series if not _SERIES.match(ln)]
    assert not bad, f"malformed series lines: {bad}"
    types = [ln for ln in lines if ln.startswith("# TYPE")]
    assert len(types) == len({t.split()[2] for t in types}), \
        "duplicate # TYPE headers"
    for needle in ('name="stale_epoch_rejected"} 3',
                   'name="gateway_shed_quota"} 2',
                   'name="retry_attempts"} 7',
                   'name="span_buffer_depth"} 1',
                   'model="resnet18"'):
        assert needle in text, f"missing {needle!r} in exposition"
    assert 'note' not in text, "non-numeric gauge leaked"
    return {"selftest": "ok", "series": len(series),
            "metrics": len(types)}


def main(argv: list[str] | None = None) -> int:
    from idunno_tpu_torch.tools import device, parser, stamp

    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--ip", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9400,
                    help="the node's control port")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)
    dev = device(args.cpu)
    if dev is None:
        return 2
    if args.selftest:
        rec = selftest()
    else:
        text = scrape(args.ip, args.port, timeout=args.timeout)
        rec = {"ip": args.ip, "port": args.port,
               "series": sum(1 for ln in text.splitlines()
                             if ln and not ln.startswith("#")),
               "text": text}
    print(json.dumps(stamp(rec, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
