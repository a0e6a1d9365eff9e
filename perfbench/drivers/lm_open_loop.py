"""Chat serving: an open loop of Poisson arrivals at a fixed rate into one
``DecodeServer`` pool, requests sharing system prompts.

Set-up: the seeded model (bfloat16, on the card), the paged pool of the
mix (radix prefix cache over a block pool read by K3, replayed decode
dispatches), and a warm-up that sends one request for each system prompt
(each prompt bucket of a cache miss) and one request that hits for each
bucket that a hit's tail takes, so that every shape of the window is built
and the system prompts sit in the radix cache as in a running
deployment. Window: the requests due in it, each submitted at the first
loop boundary at or after its due time; the same arrivals go on for
``tail_seconds`` after it (offered, not measured), so that the window's
last requests meet the load the others met; then the pool drains, for at
most ``drain_seconds``.

``ttft_p95_ms``: the 95th percentile (nearest rank), over every request
due in the window, of the time from its due time to the end of the
``step`` in which the pool admitted it, when its first token can be read
(the pool admits in submission order, so the ``admitted`` counter names
them). A request with no first token by the drain's end counts as never
served: its time is infinite, and it is a failed request.
"""
from __future__ import annotations

import math
import time

from perfbench import harness, traffic
from perfbench.drivers import lm_common
from perfbench.harness import Outcome, Window, clock


def schedule(cell, seed: int, seconds: float, tail_s: float = 0.0,
             rate: float | None = None
             ) -> tuple[list[list[int]], list[tuple[float, int, list[int], int]]]:
    """(system prompts, requests): each request (due s, system prompt,
    prompt tokens, new tokens). Those due in [0, seconds) come first, each
    seed drawing the same gaps and lengths in its own order; then those of
    the tail, due in [seconds, seconds + tail_s), drawn the same way."""
    t, c = cell.traffic, cell.config
    vocab = c["vocab_size"]
    rate = rate or t["rate_per_s"]
    tok = traffic.rng(seed, "tokens")
    systems = [traffic.tokens(tok, t["system_prompt_tokens"], vocab)
               for _ in range(t["system_prompts"])]
    arrivals, lens = traffic.rng(seed, "arrivals"), traffic.rng(seed, "lengths")
    choice = traffic.rng(seed, "choice")
    reqs = []
    for start, span in ((0.0, seconds), (seconds, tail_s)):
        due = start + traffic.poisson_arrivals(rate, span, arrivals)
        n = len(due)
        tails = traffic.spread_ints(n, *t["tail_tokens"], lens)
        news = traffic.spread_ints(n, *t["new_tokens"], lens)
        which = traffic.balanced(n, len(systems), choice)
        reqs += [(float(due[i]), int(which[i]),
                  systems[which[i]] + traffic.tokens(tok, int(tails[i]), vocab),
                  int(news[i])) for i in range(n)]
    return systems, reqs


def warm(srv, cell, seed: int) -> None:
    """Every prompt shape of the window built, the system prompts cached:
    one cold request a system prompt, its tail cycling over the tails
    that reach each bucket a miss takes, then one request that hits for
    each bucket a hit's tail takes."""
    t, vocab = cell.traffic, cell.config["vocab_size"]
    tok = traffic.rng(seed + 1, "tokens")
    systems, _ = schedule(cell, seed, 0.0)
    lo, hi = t["tail_tokens"]
    head = t["system_prompt_tokens"]

    def clip(n: int) -> int:
        return min(hi, max(lo, n))

    buckets = srv.prompt_buckets
    cold = sorted({clip(b - head) for b in buckets if b > head}) or [hi]
    hits = sorted({clip(b) for b in buckets if b <= hi}) or [hi]
    for i, s in enumerate(systems):
        srv.submit(s + traffic.tokens(tok, cold[i % len(cold)], vocab),
                   max_new=2)
        srv.run_until_drained()
    for n in hits:
        srv.submit(systems[0] + traffic.tokens(tok, n, vocab), max_new=2)
    srv.run_until_drained()


def serve(srv, reqs: list, win: Window, tail_s: float, drain_s: float
          ) -> dict:
    """Offer ``reqs`` to ``srv`` on their due times from the window's
    start (``win`` is started here): those due in the window are
    measured; those due in the ``tail_s`` after it keep the load on while
    the window's last requests are served, and a traced run profiles the
    tail's last ``win.trace_len`` seconds. Then the pool drains, for at
    most ``drain_s``. Returns each request's first-token time, the
    completions, and the pool's counters at the window's start and close."""
    base = lm_common.counters(srv)
    rids: dict[int, int] = {}          # pool request id → request index
    order: list[int] = []              # request indices, submission order
    first: dict[int, float] = {}       # request index → first token time
    done: dict[int, tuple] = {}        # pool request id → (seen, completion)
    t0 = win.start()
    stop_offer = win.close + tail_s
    trace_at = stop_offer - win.trace_len if win.traced else math.inf
    nxt, admitted, late = 0, base["admitted"], 0.0
    end, at_close, tracing = None, 0, False
    while True:
        now = clock()
        if end is None and not win.tick(now):
            win.finish()
            end, at_close = lm_common.counters(srv), len(done)
        if not tracing and now >= trace_at:
            win.open_trace()
            tracing, trace_at = True, math.inf
        if tracing and now >= stop_offer:
            win.close_trace()
            tracing = False
        offering = nxt < len(reqs)
        while nxt < len(reqs) and t0 + reqs[nxt][0] <= now:
            late = max(late, now - t0 - reqs[nxt][0])
            rids[srv.submit(reqs[nxt][2], reqs[nxt][3])] = nxt
            order.append(nxt)
            nxt += 1
        if not offering and not tracing and (
                not srv.pending() or now > stop_offer + drain_s):
            break
        if not srv.pending():
            wait = (t0 + reqs[nxt][0] - now) if nxt < len(reqs) else 1e-3
            time.sleep(min(max(wait, 0.0), 1e-3))
            continue
        srv.step()
        now = clock()
        st = srv.stats()["admitted"]
        for k in range(admitted - base["admitted"], st - base["admitted"]):
            first[order[k]] = now
        admitted = st
        for c in srv.poll():
            done[c.id] = (now, c)
    return {"t0": t0, "base": base, "end": end, "rids": rids, "order": order,
            "first": first, "done": done, "late": late,
            "completed_at_close": at_close}


def run(cell, seed: int, seconds: float, traced: bool, device,
        control: bool = False) -> Outcome:
    t = cell.traffic
    cuda = device.type == "cuda"
    pool = t["pool"]
    srv = lm_common.build_pool(lm_common.build_model(cell, seed, device),
                               pool, device)
    warm(srv, cell, seed)
    tail_s = t["tail_seconds"]
    _, every = schedule(cell, seed, seconds, tail_s)
    n = sum(1 for r in every if r[0] < seconds)
    win = Window(seconds, t["trace"], traced, cuda,
                 snap=lambda: lm_common.counters(srv))
    s = serve(srv, every, win, tail_s, t["drain_seconds"])
    reqs = every[:n]
    t0, base, end, done = s["t0"], s["base"], s["end"], s["done"]
    first, order, rids = s["first"], s["order"], s["rids"]
    out = Outcome()
    out.counters["window_start"] = t0
    out.memory_peak_bytes = harness.peak_memory(device)
    out.trace = win.trace_summary()
    out.trace_counters = win.trace_counters
    ttft = [first.get(i, math.inf) - (t0 + reqs[i][0]) for i in range(n)]
    out.end_to_end["ttft_p95_ms"] = traffic.percentile(ttft, 95) * 1e3
    waits, finished = [], []
    for rid, (seen, c) in done.items():
        i = rids[rid]
        prompt = every[i][2]
        if c.tokens[:len(prompt)] != prompt or c.prompt_len != len(prompt):
            continue
        finished.append((prompt, c.tokens[len(prompt):]))
        if i < n:
            waits.append(seen - c.service_s - (t0 + reqs[i][0]))
    admitted = end["admitted"] - base["admitted"]
    prompt_tokens = sum(len(every[order[k]][2]) for k in range(admitted))
    out.counters.update(
        window_s=win.t_end - t0, requests=n, queue_wait_s=waits,
        generated=end["generated"] - base["generated"], admitted=admitted,
        cached_tokens_saved=(end["cached_tokens_saved"]
                             - base["cached_tokens_saved"]),
        prompt_tokens=prompt_tokens, generator_late_s=s["late"],
        mean_hit=_mean_hit(base, end))
    del srv
    harness.free_device(device)
    out.attempted = n
    readings = lm_common.served_check(
        cell, seed, device,
        lm_common.sample(seed, finished, t["check"]["requests"]), control)
    readings["unserved"] = len(every) - len(finished)
    out.readings = readings
    out.failed = readings["unserved"]
    out.compared = harness.limits_check(cell.limits, readings)
    return out


def _mean_hit(base: dict, end: dict) -> float:
    n = end["admitted"] - base["admitted"]
    return (end["cached_tokens_saved"] - base["cached_tokens_saved"]) / n \
        if n else 0.0
