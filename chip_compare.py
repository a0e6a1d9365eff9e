#!/usr/bin/env python3
"""Two trees of the port measured in turns on one NVIDIA card.

Run from the root of the repository, with an unpacked copy of the parent
commit (``git archive <commit> | tar -x -C .archive/parent``):

    python3 chip_compare.py .archive/parent

It runs one process per turn, parent, change, change, parent, each from
its own tree (importing that tree's ``chip_smoke`` and
``idunno_tpu_torch``, whose kernels it builds there), and each process
measures the same things:

- K2 (bf16, causal) at [4, 1024, 16, 64] and [8, 1024, 16, 64] by CUDA
  graph replay (a launch takes about as long as its wrapper takes to
  enqueue it), K4 and K5 at [8, 1024, 16, 64] by CUDA events over a loop
  of launches and by graph replay, K3 at the served decode shape (bf16
  pages of 12 layers in turn, as ``chip_smoke.phase_paged_timing``) by
  graph replay;
- one LM prefill forward ([4, 1024] tokens, the full-width bf16 model,
  ``make_attn_fn("auto")``) under ``torch.profiler``: device time,
  kernel launches, K2's part; and the untraced forwards' tokens/s, over
  all five and from the fastest;
- one decode dispatch of the paged ``DecodeServer`` (16 live rows, 16
  model steps) under ``torch.profiler``: device time, launches and K3's
  part;
- the LM train step (seq 1024 × batch 8, f32 master weights, bf16
  compute): the median and the least of 11 untraced steps, tokens/s and
  MFU from the median, and one traced step's device time, busy share
  and K2 + K4 + K5 part.

Each turn prints one JSON line ``{"turn": ..., "tree": ..., ...}``. It
exits non-zero when a turn fails or no card is present.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

TURNS = ("parent", "change", "change", "parent")
TRAIN_STEPS = 11   # untraced steps a turn; the host sets their pace


def _device_ms(by_name, *needles) -> float:
    return sum(v for k, v in by_name.items() if any(n in k for n in needles))


def measure() -> dict:
    """The measurements of one turn, from the tree in the working
    directory."""
    sys.path[0] = os.getcwd()   # this tree's modules, not the caller's
    import torch

    import chip_smoke as c
    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.engine.train import adamw, flat_tx
    from idunno_tpu_torch.engine.train_lm import (create_lm_train_state,
                                                  make_lm_train_step)
    from idunno_tpu_torch.models.transformer import (TransformerLM,
                                                     make_attn_fn)
    from idunno_tpu_torch.ops import cuda_build
    from idunno_tpu_torch.ops import flash_attention as fa
    from idunno_tpu_torch.ops.paged_attention import paged_attention_kernel
    from idunno_tpu_torch.utils.lm_bench import (lm_bench_config,
                                                 prefix_bench_workload,
                                                 serving_max_new)
    from idunno_tpu_torch.utils.train_bench import (H100_BF16_FLOPS,
                                                    lm_flops_per_token,
                                                    train_bench_config)

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is present")
    rec = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]}
    t0 = time.time()
    cuda_build.build(list(c.SOURCES))
    rec["build_s"] = time.time() - t0

    for b in (4, 8):
        q, k, v = c.flash_inputs((b, 1024, 16, 64), 30)
        rec[f"k2_ms_b{b}"] = c.graph_ms(
            lambda: fa.flash_attention_kernel(q, k, v, causal=True), 50)
    q, k, v, do, out, lse = c.flash_bwd_inputs((8, 1024, 16, 64), "bf16",
                                               True, 60)
    delta = fa.attention_delta(out, do)
    bwd = {"k4": lambda: fa.flash_attention_bwd_dq_kernel(
               q, k, v, do, lse, delta, causal=True),
           "k5": lambda: fa.flash_attention_bwd_dkv_kernel(
               q, k, v, do, lse, delta, causal=True)}
    for name, fn in bwd.items():
        rec[f"{name}_ms"] = c.cuda_ms(fn, 20)
        rec[f"{name}_graph_ms"] = c.graph_ms(fn, 20)
    del q, k, v, do, out, lse, delta, bwd

    layers = 12
    q5, kp, vp, tables, lengths, _, _ = c.paged_inputs(
        b=16, t=1, kvh=16, g=1, d=64, n=68, bs=c.LM_BLOCK,
        chains=[0] + [3] * 15, int8=False, seed=40, layers=layers)
    turn = iter(range(10 ** 9))

    def k3():
        i = next(turn) % layers
        return paged_attention_kernel(q5, kp[i], vp[i], tables, lengths)

    rec["k3_graph_ms"] = c.graph_ms(k3, 240)
    del q5, kp, vp, tables, lengths

    cfg = lm_bench_config()
    lm = c.build_lm(cfg, "bf16", depth=cfg["depth"], seed=0)
    lm.set_attn_fn(make_attn_fn("auto"))
    b, t = cfg["prefill_batch"], cfg["prefill_seq"]
    toks = torch.randint(1, cfg["vocab"], (b, t), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(5))
    with torch.no_grad():
        lm(toks)
        fwd_s = []
        for _ in range(c.LM_FORWARDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm(toks)
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t0)
        rec["prefill_tokens_per_s"] = c.LM_FORWARDS * b * t / sum(fwd_s)
        rec["prefill_tokens_per_s_best"] = b * t / min(fwd_s)
        wall, by_name, n = c.device_profile(lambda: lm(toks))
    rec["prefill"] = {"wall_ms": wall, "launches": n,
                      "device_ms": sum(by_name.values()),
                      "k2_ms": _device_ms(by_name, "flash_fwd")}

    prompts, _, buckets = prefix_bench_workload(cfg, c.LM_BLOCK)
    srv = DecodeServer(lm, paged_kernel="auto", device="cuda",
                       **c.lm_pool_kw(cfg, buckets))
    srv.warmup()
    for p in prompts[:cfg["slots"]]:
        srv.submit(p, max_new=serving_max_new(cfg))
    srv.step()
    wall, by_name, n = c.device_profile(srv.step)
    srv.run_until_drained()
    rec["decode_dispatch"] = {"wall_ms": wall, "launches": n,
                              "device_ms": sum(by_name.values()),
                              "k3_ms": _device_ms(by_name, "paged_fwd"),
                              "model_steps": srv.decode_steps}
    del srv, lm
    torch.cuda.empty_cache()

    tcfg = train_bench_config("cuda")
    b, t = tcfg["batch"], tcfg["seq"]
    tokens = torch.randint(0, tcfg["vocab"], (b, t), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(0))
    model = TransformerLM(vocab=tcfg["vocab"], dim=tcfg["dim"],
                          depth=tcfg["depth"], num_heads=tcfg["heads"],
                          attn_fn=make_attn_fn("flash"), dtype=torch.float32,
                          compute_dtype=torch.bfloat16)
    state = create_lm_train_state(
        model, torch.Generator(device="cuda").manual_seed(0),
        flat_tx(adamw(3e-4)))
    step = make_lm_train_step(model, state.optimizer)
    for _ in range(3):
        step(state, tokens)
    times = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(state, tokens)["loss"])
        times.append(time.perf_counter() - t0)
    step_s = sorted(times)[TRAIN_STEPS // 2]
    n_params = sum(p.numel() for p in model.parameters())
    wall, by_name, n = c.device_profile(lambda: step(state, tokens))
    busy = sum(by_name.values())
    flash = _device_ms(by_name, "flash_fwd", "flash_bwd")
    rec["train"] = {
        "step_ms_median": step_s * 1e3, "step_ms_min": min(times) * 1e3,
        "tokens_per_s": b * t / step_s,
        "mfu": b * t / step_s * lm_flops_per_token(n_params, tcfg)
        / H100_BF16_FLOPS,
        "traced_wall_ms": wall, "launches": n, "device_ms": busy,
        "busy_share": busy / wall,
        "k2_ms": _device_ms(by_name, "flash_fwd"),
        "k4_ms": _device_ms(by_name, "flash_bwd_dq"),
        "k5_ms": _device_ms(by_name, "flash_bwd_dkv"),
        "flash_share_of_device": flash / busy}
    return rec


def main() -> int:
    if sys.argv[1:] == ["--turn"]:
        print(json.dumps(measure()), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": os.path.abspath(sys.argv[1]),
             "change": os.path.dirname(os.path.abspath(__file__))}
    failed = False
    for i, turn in enumerate(TURNS):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn"],
            cwd=trees[turn], capture_output=True, text=True, timeout=1200)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            failed = True
            rec = {"error": proc.stderr[-3000:]}
        else:
            rec = json.loads(lines[-1])
        print(json.dumps({"turn": i + 1, "tree": turn, **rec}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
