"""Long generations at a full batch: a closed loop of clients on one
``DecodeServer`` pool, each client sending its next request when its last
one completes.

Set-up: the seeded model (bfloat16, on the card), the paged pool of the
mix, and a warm-up request per prompt bucket (which also records the
replayed decode dispatch). Window: every client sends a request at its
start; each completion seen at a loop boundary sends that client's next
one. Prompts are unshared, so the radix cache finds nothing to reuse.

``tokens_per_s``: every token generated inside the window (by retired rows,
and by the rows still live when it closes) over the window, which closes
at the end of the first ``step`` that ends after ``--seconds``.
"""
from __future__ import annotations

from perfbench import harness, traffic
from perfbench.drivers import lm_common
from perfbench.harness import Outcome, Window


def run(cell, seed: int, seconds: float, traced: bool, device,
        control: bool = False) -> Outcome:
    t, vocab = cell.traffic, cell.config["vocab_size"]
    cuda = device.type == "cuda"
    pool = t["pool"]
    srv = lm_common.build_pool(lm_common.build_model(cell, seed, device),
                               pool, device)
    tok = traffic.rng(seed, "tokens")
    warm = traffic.rng(seed + 1, "tokens")
    for b in srv.prompt_buckets:
        srv.submit(traffic.tokens(warm, b, vocab), max_new=2)
    srv.run_until_drained()
    base = lm_common.counters(srv)
    prompts: dict[int, list[int]] = {}
    finished, wrong = [], 0
    win = Window(seconds, t["trace"], traced, cuda)

    def send() -> None:
        p = traffic.tokens(tok, t["prompt_tokens"], vocab)
        prompts[srv.submit(p, t["new_tokens"])] = p

    def step() -> None:
        nonlocal wrong
        srv.step()
        for c in srv.poll():
            p = prompts.pop(c.id)
            if c.tokens[:len(p)] == p and c.prompt_len == len(p):
                finished.append((p, c.tokens[len(p):]))
            else:
                wrong += 1
            send()

    win.start()
    for _ in range(t["clients"]):
        send()
    while win.tick():
        step()
    span = win.finish()
    end = lm_common.counters(srv)
    win.trace_after(step)
    out = Outcome()
    out.counters["window_start"] = win.t0
    out.memory_peak_bytes = harness.peak_memory(device)
    out.trace = win.trace_summary()
    generated = end["generated"] - base["generated"]
    out.end_to_end["tokens_per_s"] = generated / span
    admitted = end["admitted"] - base["admitted"]
    out.counters.update(
        window_s=span, generated=generated, admitted=admitted,
        prompt_tokens=admitted * t["prompt_tokens"],
        cached_tokens_saved=(end["cached_tokens_saved"]
                             - base["cached_tokens_saved"]),
        completed=len(finished), clients=t["clients"])
    out.attempted = admitted
    del srv
    harness.free_device(device)
    readings = lm_common.served_check(
        cell, seed, device,
        lm_common.sample(seed, finished, t["check"]["requests"]), control)
    readings["unserved"] = wrong + (0 if finished else 1)
    out.readings = readings
    out.failed = readings["unserved"]
    out.compared = harness.limits_check(cell.limits, readings)
    return out

