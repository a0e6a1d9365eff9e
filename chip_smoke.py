#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``idunno_tpu_torch``) on one NVIDIA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``idunno_tpu_torch/csrc/`` with
``nvcc`` (all sources at once), holds each against its plain PyTorch
version, times it, and then drives the port's three main paths:

- CNN serving: ResNet-18 and AlexNet at full width (224² crops of 256²
  images, engine batch 256, seeded random weights) served by an
  in-process cluster of three hosts (membership, fair scheduler,
  inference service) around one engine on the card — kernel K1;
- LM serving: the 0.2 B-parameter ``TransformerLM`` (dim 1024, depth 12,
  16 heads, vocab 32768, bf16, seeded random weights) — its full forward
  prefill through the flash kernel K2, and a continuous-batching
  ``DecodeServer`` with the paged KV block pool and radix prefix cache,
  driven by ``LMServingLoop`` from two request threads, attending cached
  prefixes through the paged kernel K3;
- LM training: the same 0.2 B-parameter model with f32 master parameters
  and bf16 compute, trained on seq 1024 × batch 8 by the port's LM train
  step (next-token cross-entropy, fused AdamW), attending through the
  flash forward K2 and the flash backward kernels K4 (dQ) and K5 (dK, dV)
  joined in one ``torch.autograd.Function``; then the train bench
  (``utils/train_bench.py``: the LM, gradient-accumulation and ResNet-18
  points).

Phases:

1. card and build: the card's name and power limit, ``-Xptxas -v``
   (a spill in the bf16 tensor-core kernels, K2, K4 and K5, fails the
   run);
2. every kernel against its plain version, at the main paths' shapes
   (bf16 K2, K4 and K5 within the per-element bound of their bf16
   rounding of P and dS, ``ops/flash_attention.py:tensor_core_bound``);
3. kernel timing by CUDA-graph replay (K4 and K5 also by CUDA events; K3
   at the decode and the radix-hit prefill shapes), beside its bound, the
   plain time and, where one exists, one PyTorch library call computing
   the same function;
4. CNN serving: concurrent ``resnet`` and ``alexnet`` queries of 1024
   images each; every record must come back, no engine error may be
   reported, and the K1 launch count, zeroed just before, must rise;
5. CNN preprocess paths on the same weights: ``kernel`` logits against
   ``plain`` and ``fold``, the card's logits against an f32 CPU reference
   on 8 images, and each path's images/s;
6. LM prefill: the full-width forward on [4, 1024] tokens through
   ``make_attn_fn("auto")``; K2 launches must equal depth × forwards, and
   the logits must agree with the ``full`` attention forward; one forward
   under ``torch.profiler`` gives K2's share of the device time;
7. LM serving: 48 shared-prefix prompts from two threads; every request
   completes with prompt + max_new in-vocab tokens, radix hits > 0, K3
   launches (zeroed just before) > 0, no loop errors; tokens/s and TTFT;
8. LM token exactness: the same workload at full width, depth 2, f32, on
   a ``paged_kernel="kernel"`` and a ``"plain"`` pool: equal greedy
   streams;
9. LM training (``lm_train``): one batch from a ``TokenDataset`` over a
   seeded corpus; the gradients of every parameter through flash and
   through ``full`` attention agree (cosine ≥ 0.999, norms within 2%);
   ten steps on that batch with finite, falling loss, K2, K4 and K5
   launches (zeroed just before) each equal to depth × 10, and f32 master
   parameters after; one step under ``torch.profiler``; then the train
   bench's record, with no point in error;
10. one JSON line ``{"kernels": [...]}``;
11. the last line, ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero without the last line.
It also exits non-zero when no CUDA card is present, or when the package
is not beside it.
"""
from __future__ import annotations

import json
import math
import random
import subprocess
import sys
import time

CROP, SIDE, BATCH = 224, 256, 256
N_QUERY = 1024                   # images per model query in phase 4
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
# kernel name → the CUDA source (``idunno_tpu_torch/csrc/<source>.cu``)
KERNELS = {"preprocess": "preprocess", "flash_attention": "flash_attention",
           "paged_attention": "paged_attention",
           "flash_attention_bwd_dq": "flash_attention_bwd",
           "flash_attention_bwd_dkv": "flash_attention_bwd"}
SOURCES = tuple(dict.fromkeys(KERNELS.values()))
TC_KERNELS = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")  # bf16
LM_BLOCK = 16                    # KV block size of the served pool
LM_DECODE_STEPS = 16             # decode steps per DecodeServer.step()
LM_FORWARDS = 5                  # timed prefill forwards in phase 6
LM_TRAIN_STEPS = 10              # train steps on one batch in phase 9


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches, by CUDA
    events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device milliseconds of ``fn`` with the host out of the way:
    ``iters`` calls captured into one CUDA graph, replayed ``replays``
    times between CUDA events. For calls whose device time is shorter
    than the host's enqueue time (a small kernel behind a Python
    wrapper), where `cuda_ms` would time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


class StepClock:
    """Membership clock the script advances by hand, as the tests do."""

    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# -- phases -------------------------------------------------------------


def phase_build() -> str:
    from idunno_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    cuda_build.build(list(SOURCES))
    say("build", seconds=round(time.time() - t0, 3), sources=list(SOURCES))
    spilled = []
    for name in SOURCES:
        summary = ptxas_summary(cuda_build.ptxas_report(name))
        print(f"ptxas {name}.cu:", flush=True)
        print(summary, flush=True)
        spilled += [line.strip() for line in summary.splitlines()
                    if any(k in line.split(":")[0] for k in TC_KERNELS)
                    and not ("0 bytes spill stores" in line
                             and "0 bytes spill loads" in line)]
    # the tensor-core kernels keep their fragments and accumulators in
    # registers by design: a spill means the design is wrong
    if spilled:
        raise AssertionError(f"tensor-core kernels spill: {spilled}")
    return smi


def ptxas_summary(report: str) -> str:
    """One line per compiled kernel of an ``-Xptxas -v`` report: its name,
    then registers, shared memory and spills."""
    lines, spill = [], ""
    fn = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn:
            lines.append(f"  {fn}: {line.split(':', 1)[1].strip()}; {spill}")
            fn, spill = None, ""
    return "\n".join(lines)


def kernel_wrappers() -> dict:
    """Kernel name → its wrapper, which carries the ``launches`` count."""
    from idunno_tpu_torch.ops import flash_attention as fa
    from idunno_tpu_torch.ops.paged_attention import paged_attention_kernel
    from idunno_tpu_torch.ops.preprocess_kernel import preprocess_batch_kernel

    return {"preprocess": preprocess_batch_kernel,
            "flash_attention": fa.flash_attention_kernel,
            "paged_attention": paged_attention_kernel,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_kernel,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv_kernel}


def zero_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def phase_kernel_vs_plain() -> float:
    """K1 against its plain version; returns the largest |difference|."""
    import torch

    from idunno_tpu_torch.ops.flash_attention import bf16_ulp
    from idunno_tpu_torch.ops.preprocess_kernel import (
        preprocess_batch_kernel, preprocess_batch_plain)

    g = torch.Generator().manual_seed(0)
    worst = 0.0
    for batch, side in ((BATCH, SIDE), (3, 240)):
        x = torch.randint(0, 256, (batch, side, side, 3), dtype=torch.uint8,
                          generator=g).cuda()
        out = preprocess_batch_kernel(x, CROP)
        ref = preprocess_batch_plain(x, CROP)
        torch.cuda.synchronize()
        assert out.shape == (batch, CROP, CROP, 3) and out.dtype == torch.bfloat16
        diff = (out.float() - ref.float()).abs()
        ulps = float((diff.double() / bf16_ulp(
            torch.maximum(out.float().abs(), ref.float().abs()))).max())
        neq = int((out.view(torch.int16) != ref.view(torch.int16)).sum())
        say("kernel_vs_plain", kernel="preprocess", batch=batch, side=side,
            max_abs_err=float(diff.max()), max_ulps=ulps, not_bitwise_equal=neq)
        if not ulps <= 1.0:
            raise AssertionError(f"preprocess kernel off by {ulps} bf16 ulps")
        worst = max(worst, float(diff.max()))
    return worst


def phase_timing() -> dict:
    import torch

    from idunno_tpu_torch.ops.preprocess_kernel import (
        preprocess_batch_kernel, preprocess_batch_plain)

    x = torch.randint(0, 256, (BATCH, SIDE, SIDE, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1)).cuda()
    # 50 MB in + 77 MB out per launch: more than the 50 MB L2, so
    # back-to-back launches read and write device memory. Graph replay: on
    # a slow host the wrapper's enqueue time approaches the kernel's 46 µs
    kernel_ms = graph_ms(lambda: preprocess_batch_kernel(x, CROP), 100)
    plain_ms = cuda_ms(lambda: preprocess_batch_plain(x, CROP), 20)
    elems = BATCH * CROP * CROP * 3
    bytes_ms = (elems * 1 + elems * 2) / HBM_BYTES_PER_S * 1e3
    ops_ms = elems * 3 / F32_FLOPS_PER_S * 1e3
    t = {"ms": kernel_ms, "plain_ms": plain_ms,
         "bound_ms": max(bytes_ms, ops_ms),
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
         "library_ms": None}
    say("timing", kernel="preprocess", batch=BATCH, **t,
        achieved_gb_per_s=(elems * 3) / (kernel_ms * 1e-3) / 1e9,
        timed_by="cuda graph replay")
    return t


def phase_serving(engine) -> int:
    """Concurrent resnet + alexnet queries through a 3-host in-process
    cluster; returns the kernel launches the run made."""
    from idunno_tpu_torch.comm.inproc import InProcNetwork
    from idunno_tpu_torch.config import ClusterConfig
    from idunno_tpu_torch.membership.service import MembershipService
    from idunno_tpu_torch.scheduler.fair import FairScheduler
    from idunno_tpu_torch.serve.inference_service import InferenceService
    from idunno_tpu_torch.serve.metrics import MetricsTracker

    cfg = ClusterConfig(hosts=("n0", "n1", "n2"), coordinator="n0",
                        standby_coordinator="n1", introducer="n0",
                        query_batch_size=N_QUERY, query_interval_s=0.0)
    net, clock = InProcNetwork(), StepClock()
    members, services = {}, {}
    for h in cfg.hosts:
        t = net.transport(h)
        members[h] = MembershipService(h, cfg, t, clock=clock)
        services[h] = InferenceService(
            h, cfg, t, members[h], engine,
            metrics=MetricsTracker(clock=clock),
            scheduler=FairScheduler(cfg, rng=random.Random(0), clock=clock),
            clock=clock)
    for h in cfg.hosts:
        members[h].join()
        clock.advance(0.01)
    for _ in range(3):
        for m in members.values():
            m.ping_once()
        clock.advance(0.3)

    zero_launches()
    t0 = time.time()
    qr = services["n2"].submit_query("resnet", 0, N_QUERY - 1)
    qa = services["n1"].submit_query("alexnet", 0, N_QUERY - 1)
    master = services["n0"]
    rounds = 0
    while not (master.query_done("resnet", qr)
               and master.query_done("alexnet", qa)):
        # the service catches engine exceptions and re-dispatches the task;
        # the master's error count is what shows them
        errors = {m: n for s in services.values()
                  for m, n in s._task_errors.items()}
        if errors:
            raise AssertionError(f"engine errors reported: {errors}")
        rounds += 1
        if rounds > 20:
            raise AssertionError("queries not done within 20 rounds")
        for s in services.values():
            s.process_jobs_once()
    wall = time.time() - t0
    launches = read_launches()["preprocess"]
    errors = {m: n for s in services.values()
              for m, n in s._task_errors.items()}
    if errors:
        raise AssertionError(f"engine errors reported: {errors}")
    want = {f"test_{i}.JPEG" for i in range(N_QUERY)}
    for model, q in (("resnet", qr), ("alexnet", qa)):
        recs = master.results(model, q)
        if len(recs) != N_QUERY or {r[0] for r in recs} != want:
            raise AssertionError(f"{model}: {len(recs)} records of {N_QUERY}")
        if not all(isinstance(c, str) and math.isfinite(p) and 0.0 <= p <= 1.0
                   for _, c, p in recs):
            raise AssertionError(f"{model}: malformed record")
    if launches < 8:
        raise AssertionError(f"preprocess kernel launched {launches} times "
                             "while serving; expected at least 8")
    say("serving", rounds=rounds, wall_s=wall, images=2 * N_QUERY,
        images_per_s=2 * N_QUERY / wall, preprocess_launches=launches,
        weights=master.weights_provenance())
    return launches


def phase_paths(engines: dict, card: str) -> None:
    """Logits of each preprocess path on the same weights, an f32 CPU
    reference on 8 images, and images/s of each path."""
    import numpy as np
    import torch

    from idunno_tpu_torch.config import EngineConfig
    from idunno_tpu_torch.engine import data as data_lib
    from idunno_tpu_torch.engine.inference import InferenceEngine

    _, images = data_lib.load_range(None, 0, BATCH - 1)
    batch = torch.from_numpy(images).cuda()
    cpu_ref = InferenceEngine(EngineConfig(
        batch_size=BATCH, image_size=CROP, resize_size=SIDE,
        compute_dtype="float32", preprocess="plain"), device="cpu", seed=0)
    # tolerances relative to the largest |logit|, bf16 compute on the card:
    # kernel vs plain differ only where the f32 normalize rounds to another
    # bf16 input (divide vs multiply); fold moves the rounding from the
    # inputs to the scaled stem weights; the f32 CPU reference differs by
    # the whole network's bf16 rounding
    tol = {"plain": 2e-2, "fold": 5e-2, "cpu_f32": 5e-2}
    for name in ("resnet", "alexnet"):
        ref = engines["kernel"].logits(name, batch)
        for other in ("plain", "fold"):
            out = engines[other].logits(name, batch)
            rel = float((out - ref).abs().max() / ref.abs().max())
            say("paths", model=name, compare=f"kernel_vs_{other}",
                max_rel_err=rel, tolerance=tol[other])
            if not rel <= tol[other]:
                raise AssertionError(f"{name}: kernel vs {other} off by {rel}")
        if not bool(torch.isfinite(ref).all()) or ref.shape != (BATCH, 1000):
            raise AssertionError(f"{name}: bad logits {tuple(ref.shape)}")
        cpu = cpu_ref.logits(name, torch.from_numpy(np.ascontiguousarray(images[:8])))
        rel = float((ref[:8].float().cpu() - cpu).abs().max() / cpu.abs().max())
        say("paths", model=name, compare="card_kernel_vs_cpu_f32_plain",
            max_rel_err=rel, tolerance=tol["cpu_f32"])
        if not rel <= tol["cpu_f32"]:
            raise AssertionError(f"{name}: card vs CPU reference off by {rel}")
    # images/s: ``infer`` once per path (host decode included), and
    # ``infer_staged`` on one block already on the card, the paths taken
    # in turns (kernel, plain, fold, fold, plain, kernel) four times over
    _, block = data_lib.load_range(None, 0, N_QUERY - 1)
    staged, n = engines["kernel"].stage(block)
    turns = ["kernel", "plain", "fold", "fold", "plain", "kernel"] * 4
    for name in ("resnet", "alexnet"):
        rates = {mode: [] for mode in engines}
        for mode, eng in engines.items():
            eng.infer_staged(name, staged, n)              # warm
            res = eng.infer(name, 0, N_QUERY - 1)
            rates[mode].append(N_QUERY / res.elapsed_s)
        staged_rates = {mode: [] for mode in engines}
        for mode in turns:
            t0 = time.time()
            engines[mode].infer_staged(name, staged, n)
            staged_rates[mode].append(n / (time.time() - t0))
        for mode in engines:
            r = sorted(staged_rates[mode])
            say("paths", model=name, preprocess=mode, card=card,
                infer_images_per_s=rates[mode][0],
                staged_images_per_s_median=(r[3] + r[4]) / 2,
                staged_images_per_s_min=r[0], staged_images_per_s_max=r[-1])


# -- LM kernels and paths (K2, K3) ----------------------------------------

# bf16 (the tensor-core kernel): the prefill shape causal and not, the
# training shape, a ragged T = 1000, and head_dim 32
FLASH_CHECKS = (((4, 1024, 16, 64), True), ((4, 1024, 16, 64), False),
                ((8, 1024, 16, 64), True), ((4, 1000, 16, 64), True),
                ((4, 1000, 16, 32), False))


def flash_inputs(shape, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda")
                 .to(torch.bfloat16) for _ in range(3))


def phase_flash_vs_plain() -> float:
    """K2 (bf16, on the tensor cores) against its plain version (f32
    arithmetic) at the shapes of ``FLASH_CHECKS``: each out element within
    ``tensor_core_bound`` (the rounding of p to bf16 before P·V, carried
    through the product, plus 1 bf16 ulp of max(|out|, |ref|) + 1e-5);
    lse within 1e-3. Returns the largest |out difference|."""
    import torch

    from idunno_tpu_torch.ops.flash_attention import (flash_attention_kernel,
                                                      flash_attention_plain,
                                                      tensor_core_bound)

    worst = 0.0
    for i, (shape, causal) in enumerate(FLASH_CHECKS):
        q, k, v = flash_inputs(shape, 10 + i)
        out, lse = flash_attention_kernel(q, k, v, causal=causal)
        ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        bound = tensor_core_bound("out", out, ref, q, k, v, causal=causal)
        ratio = float((diff.double() / bound).max())
        lse_err = float((lse - ref_lse).abs().max())
        say("kernel_vs_plain", kernel="flash_attention", shape=list(shape),
            causal=causal, max_abs_err=float(diff.max()),
            max_err_over_tolerance=ratio,
            tolerance="2^-8 (P.|V|)/l + 1 bf16 ulp of max(|out|, |ref|) "
                      "+ 1e-5, per element",
            lse_max_abs_err=lse_err, lse_tolerance=1e-3)
        if not (ratio <= 1.0 and lse_err <= 1e-3 and out.dtype == q.dtype
                and lse.shape == (shape[0], shape[2], shape[1])):
            raise AssertionError(f"flash kernel off: out at {ratio} of its "
                                 f"tolerance or lse {lse_err} > 1e-3 at "
                                 f"{shape}")
        worst = max(worst, float(diff.max()))
    return worst


def paged_inputs(*, b, t, kvh, g, d, n, bs, chains, int8, seed, layers=None):
    """Decode-pool inputs: f32 queries, pages (bf16, or int8 with f32
    per-token scales; ``layers`` stacks that many layers' stores), tables
    whose live entries are distinct pages and dead entries 0, and
    block-aligned lengths ``chains[b] * bs``."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if layers is None else (layers,)
    shape = lead + (n, bs, kvh, d)
    q5 = torch.randn((b, t, kvh, g, d), generator=gen, device="cuda")
    ks = vs = None
    if int8:
        kp, vp = (torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], generator=gen, device="cuda") * 0.02
                  + 0.001 for _ in range(2))
    else:
        kp, vp = (torch.randn(shape, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
    c = max(1, max(chains))
    tables = torch.zeros((b, c), dtype=torch.int32)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    used = 0
    for r, nb in enumerate(chains):
        tables[r, :nb] = perm[used:used + nb]
        used += nb
    lengths = torch.tensor([nb * bs for nb in chains], dtype=torch.int32)
    return q5, kp, vp, tables.cuda(), lengths.cuda(), ks, vs


def paged_shapes():
    """(label, inputs kwargs) of the K3 checks: the served decode shape
    (16 slots, 16 kv-heads, bs 16, chains of 0-3 blocks, row 0 empty) and
    a radix-hit prefill (one row, 64 query positions, a 3-block chain)."""
    rng = random.Random(3)
    chains = [0] + [rng.randint(0, 3) for _ in range(15)]
    return (("decode", dict(b=16, t=1, kvh=16, g=1, d=64, n=68, bs=LM_BLOCK,
                            chains=chains)),
            ("hit_prefill", dict(b=1, t=64, kvh=16, g=1, d=64, n=68,
                                 bs=LM_BLOCK, chains=[3])))


def phase_paged_vs_plain() -> float:
    """K3 against its plain version at the decode and hit-prefill shapes,
    bf16 and int8 pages: out and lse within 1e-5 relative; empty chains
    exactly (0, -1e30). Returns the largest |out difference|."""
    import torch

    from idunno_tpu_torch.ops.paged_attention import (_paged_plain,
                                                      paged_attention_kernel)

    worst = 0.0
    for label, dims in paged_shapes():
        for int8 in (False, True):
            q5, kp, vp, tables, lengths, ks, vs = paged_inputs(
                int8=int8, seed=20 + int8, **dims)
            out, lse = paged_attention_kernel(
                q5, kp, vp, tables, lengths, k_scale_pages=ks,
                v_scale_pages=vs)
            ref, ref_lse = _paged_plain(q5, kp, vp, tables, lengths,
                                        k_scale_pages=ks, v_scale_pages=vs,
                                        scale=1.0 / dims["d"] ** 0.5)
            torch.cuda.synchronize()
            diff = float((out - ref).abs().max())
            tol = 1e-5 * float(ref.abs().max())
            lse_err = float(((lse - ref_lse).abs()
                             / ref_lse.abs().clamp_min(1.0)).max())
            empty = lengths == 0
            exact_empty = bool((out[empty] == 0).all()
                               and (lse[empty] == -1e30).all())
            say("kernel_vs_plain", kernel="paged_attention", shape=label,
                pages="int8" if int8 else "bf16", max_abs_err=diff,
                tolerance=tol, lse_max_rel_err=lse_err, lse_tolerance=1e-5,
                empty_rows=int(empty.sum()), empty_rows_exact=exact_empty)
            if not (diff <= tol and lse_err <= 1e-5 and exact_empty):
                raise AssertionError(f"paged kernel off at {label} "
                                     f"int8={int8}: out {diff}, lse {lse_err}")
            worst = max(worst, diff)
    return worst


def phase_flash_timing() -> dict:
    """K2 (bf16, causal) at the prefill shape [4, 1024, 16, 64], whose
    numbers it returns, and at the training shape [8, 1024, 16, 64],
    against its bound, its plain version and
    ``scaled_dot_product_attention``. The kernel is timed by graph
    replay: a launch takes about as long on the card as its Python
    wrapper takes to enqueue it."""
    import torch.nn.functional as F

    from idunno_tpu_torch.ops.flash_attention import (flash_attention_kernel,
                                                      flash_attention_plain)

    timed = {}
    for shape in ((4, 1024, 16, 64), (8, 1024, 16, 64)):
        b, t, h, d = shape
        q, k, v = flash_inputs(shape, 30)
        kernel_ms = graph_ms(
            lambda: flash_attention_kernel(q, k, v, causal=True), 50)
        plain_ms = cuda_ms(
            lambda: flash_attention_plain(q, k, v, causal=True), 10)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 50)
        # q, k, v read once and out written once; the causal work is the
        # T(T+1)/2 live (query, key) pairs, two D-long products each
        nbytes = 4 * q.numel() * q.element_size()
        flops = 2 * 2 * b * h * d * t * (t + 1) // 2
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        timed[shape] = {"ms": kernel_ms, "plain_ms": plain_ms,
                        "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": "bytes" if bytes_ms >= ops_ms
                        else "operations",
                        "library_ms": library_ms}
        say("timing", kernel="flash_attention", shape=list(shape),
            causal=True, **timed[shape], bytes=nbytes, flops=flops,
            timed_by="cuda graph replay",
            achieved_tflops=flops / (kernel_ms * 1e-3) / 1e12)
    return timed[(4, 1024, 16, 64)]


def phase_paged_timing() -> dict:
    """K3 at the served decode shape (16 rows, 15 with a 3-block chain as a
    radix hit of 48 tokens gives, one empty), whose numbers it returns,
    and at the radix-hit prefill shape (one row, 64 query positions, a
    3-block chain), bf16 pages. The pages of 12 layers rotate as in a
    decode step (54 MB, above the 50 MB L2), so each launch reads its
    pages from device memory."""
    from idunno_tpu_torch.ops.paged_attention import (_paged_plain,
                                                      paged_attention_kernel)

    layers, bs, d = 12, LM_BLOCK, 64
    timed = {}
    for label, b, t, chains in (("decode", 16, 1, [0] + [3] * 15),
                                ("hit_prefill", 1, 64, [3])):
        q5, kp, vp, tables, lengths, _, _ = paged_inputs(
            b=b, t=t, kvh=16, g=1, d=d, n=68, bs=bs, chains=chains,
            int8=False, seed=40, layers=layers)
        it = iter(range(10 ** 9))

        def kernel():
            i = next(it) % layers
            return paged_attention_kernel(q5, kp[i], vp[i], tables, lengths)

        # graph replay: one launch takes less device time than its wrapper
        # takes to enqueue it, so a plain loop of launches would time the
        # host
        kernel_ms = graph_ms(kernel, 240)
        host_loop_ms = cuda_ms(kernel, 240)
        plain_ms = graph_ms(lambda: _paged_plain(
            q5, kp[0], vp[0], tables, lengths, scale=1.0 / d ** 0.5), 24)
        live = sum(chains) * bs                 # live tokens over the rows
        kvh = q5.shape[2]
        nbytes = (2 * live * kvh * d * kp.element_size()       # K and V pages
                  + 2 * q5.numel() * 4 + q5.numel() // d * 4   # q, out, lse
                  + tables.numel() * 4 + lengths.numel() * 4)
        # q.k and p.v per live key and query row
        flops = 2 * 2 * live * kvh * d * t
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        timed[label] = {"ms": kernel_ms, "plain_ms": plain_ms,
                        "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": "bytes" if bytes_ms >= ops_ms
                        else "operations",
                        "library_ms": None}
        say("timing", kernel="paged_attention", shape=label, **timed[label],
            bytes=nbytes, flops=flops, live_tokens=live,
            host_loop_ms=host_loop_ms, timed_by="cuda graph replay")
    return timed["decode"]


def build_lm(cfg: dict, dtype, depth: int, seed: int):
    """The full-width TransformerLM on the card, seeded with flax's
    initialisers."""
    import torch

    from idunno_tpu_torch.models.init import init_like_flax
    from idunno_tpu_torch.models.transformer import TransformerLM

    with torch.device("cuda"):
        model = TransformerLM(vocab=cfg["vocab"], dim=cfg["dim"], depth=depth,
                              num_heads=cfg["heads"], dtype=torch.float32)
    init_like_flax(model, torch.Generator(device="cuda").manual_seed(seed))
    return model.to(torch.bfloat16 if dtype == "bf16" else torch.float32
                    ).eval().requires_grad_(False)


def phase_lm_prefill(model, cfg: dict, card: str) -> int:
    """The full forward at [4, 1024] through ``make_attn_fn("auto")`` (K2
    on the card); returns K2's launches in the timed forwards."""
    import torch

    from idunno_tpu_torch.models.transformer import make_attn_fn

    b, t = cfg["prefill_batch"], cfg["prefill_seq"]
    g = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(1, cfg["vocab"], (b, t), generator=g, device="cuda")
    rates = {}
    with torch.no_grad():
        logits = {}
        for kind in ("full", "auto"):
            model.set_attn_fn(make_attn_fn(kind))
            model(toks)                                   # warm
            torch.cuda.synchronize()
            if kind == "auto":
                zero_launches()
            t0 = time.perf_counter()
            for _ in range(LM_FORWARDS):
                out = model(toks)
            torch.cuda.synchronize()
            rates[kind] = LM_FORWARDS * b * t / (time.perf_counter() - t0)
            if kind == "auto":
                launches = read_launches()["flash_attention"]
            logits[kind] = out
    model.set_attn_fn(make_attn_fn("full"))
    ref, got = logits["full"], logits["auto"]
    if got.shape != (b, t, cfg["vocab"]) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"prefill logits bad: {tuple(got.shape)}")
    rel = float((got - ref).abs().max() / ref.abs().max())
    say("lm_prefill", card=card, batch=b, seq=t, depth=model.depth,
        forwards=LM_FORWARDS, flash_tokens_per_s=rates["auto"],
        full_tokens_per_s=rates["full"], flash_launches=launches,
        flash_vs_full_max_rel_err=rel, tolerance=2e-2)
    if launches != model.depth * LM_FORWARDS:
        raise AssertionError(f"K2 launched {launches} times in "
                             f"{LM_FORWARDS} forwards of depth {model.depth}")
    if not rel <= 2e-2:
        raise AssertionError(f"flash forward off the full forward by {rel}")
    model.set_attn_fn(make_attn_fn("auto"))
    with torch.no_grad():
        wall_ms, by_name, n = device_profile(lambda: model(toks))
    model.set_attn_fn(make_attn_fn("full"))
    busy_ms = sum(by_name.values())
    flash_ms = sum(v for k, v in by_name.items() if "flash_fwd" in k)
    say("lm_prefill_profile", card=card, wall_ms=wall_ms, kernel_launches=n,
        device_busy_ms=busy_ms if n else "not measured",
        device_busy_share=busy_ms / wall_ms if n else "not measured",
        flash_device_ms=flash_ms if n else "not measured",
        flash_share_of_device=flash_ms / busy_ms if n else "not measured",
        top_kernels_ms=dict(by_name.most_common(8)))
    return launches


def lm_pool_kw(cfg: dict, buckets) -> dict:
    return dict(slots=cfg["slots"], prompt_len=cfg["prompt_len"],
                max_len=cfg["max_len"], decode_steps=LM_DECODE_STEPS,
                prompt_buckets=buckets, kv_block_size=LM_BLOCK,
                kv_cache_blocks=(cfg["slots"] + 1) * 4)


def phase_lm_serving(model, cfg: dict, card: str) -> int:
    """48 shared-prefix prompts from two threads through an LMServingLoop
    around the full-width paged DecodeServer; returns K3's launches."""
    import threading

    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.serve.lm_pool import LMServingLoop
    from idunno_tpu_torch.utils.lm_bench import (prefix_bench_workload,
                                                 serving_max_new)
    from idunno_tpu_torch.utils.spans import SpanStore

    prompts, shared, buckets = prefix_bench_workload(cfg, LM_BLOCK)
    max_new = serving_max_new(cfg)
    srv = DecodeServer(model, paged_kernel="auto", device="cuda",
                       **lm_pool_kw(cfg, buckets))
    warm_s = srv.warmup()
    spans = SpanStore("chip")
    loop = LMServingLoop(srv, name="lm", spans=spans)
    traces: dict[int, str] = {}
    errors: list[str] = []
    lock = threading.Lock()

    def client(ps):
        try:
            for p in ps:
                tid = spans.new_trace()
                rid = loop.submit(p, max_new=max_new, trace=(tid, None))
                with lock:
                    traces[rid] = tid
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{type(e).__name__}: {e}")

    done = {}
    try:
        zero_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(prompts[i::2],))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        deadline = time.monotonic() + 600
        while len(done) < len(prompts) and time.monotonic() < deadline:
            for c in loop.poll():
                done[c.id] = c
            errors.extend(loop.errors())
            if errors:
                break
            time.sleep(0.005)
        wall = time.perf_counter() - t0
        launches = read_launches()["paged_attention"]
        stats = loop.stats()
    finally:
        loop.stop()
    errors.extend(loop.errors())
    if errors:
        raise AssertionError(f"serving loop reported errors: {errors[:5]}")
    if sorted(done) != sorted(traces) or len(done) != len(prompts):
        raise AssertionError(f"{len(done)} of {len(prompts)} requests done")
    want_len = cfg["prompt_len"] + max_new
    for c in done.values():
        if (len(c.tokens) != want_len or c.cancelled
                or not all(0 <= x < cfg["vocab"] for x in c.tokens)):
            raise AssertionError(f"request {c.id}: {len(c.tokens)} tokens, "
                                 f"want {want_len} in the vocab")
    hits = stats["prefix_cache"]["hits"]
    if hits <= 0 or launches <= 0:
        raise AssertionError(f"radix hits {hits}, K3 launches {launches}")
    ttft = []
    wire = spans.dump()
    for tid in traces.values():
        mine = {s["name"]: s for s in wire if s["trace_id"] == tid}
        ttft.append(mine["lm.prefill"]["t_end"] - mine["lm.admit"]["t_start"])
    ttft.sort()
    gen = sum(len(c.tokens) - c.prompt_len for c in done.values())
    steps = stats["dispatches"] * LM_DECODE_STEPS
    # every radix-hit prefill attends its hit through K3 once per layer
    prefill_launches = hits * model.depth
    say("lm_serving", card=card, requests=len(done), max_new=max_new,
        decode_steps_per_dispatch=LM_DECODE_STEPS, warmup_s=warm_s,
        wall_s=wall, tokens_generated=gen, tokens_per_s=gen / wall,
        ttft_p50_s=ttft[len(ttft) // 2],
        ttft_p95_s=ttft[min(len(ttft) - 1, int(0.95 * len(ttft)))],
        dispatches=stats["dispatches"], decode_model_steps=steps,
        radix_hits=hits, radix_lookups=stats["prefix_cache"]["lookups"],
        paged_launches=launches,
        paged_launches_in_hit_prefills=prefill_launches,
        paged_launches_per_decode_step=(launches - prefill_launches) / steps,
        prefill_tokens=stats["prefill_tokens"],
        kv_gather_bytes_saved=stats["kv_gather_bytes_saved"])
    profile_dispatch(srv, prompts[:cfg["slots"]], max_new, card)
    return launches


def device_profile(fn):
    """``fn`` once under ``torch.profiler``, after a synchronize: (its wall
    ms, a Counter of device ms by kernel name, the number of kernels the
    profiler recorded). The counter is empty where it records none. User
    annotations on the device timeline (the optimizer's
    ``Optimizer.step#...`` range) span kernels already counted and are
    left out."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    return wall_ms, by_name, len(kernels)


def profile_dispatch(srv, prompts, max_new: int, card: str) -> None:
    """One decode dispatch (``decode_steps`` model steps, every slot live)
    under ``torch.profiler``: its wall time, the device's kernel time and
    busy share, and the kernels that take the most of it. Prints "not
    measured" for the device numbers where the profiler records no
    kernel."""
    for p in prompts:
        srv.submit(p, max_new=max_new)
    srv.step()                             # admissions + one dispatch
    wall_ms, by_name, n = device_profile(srv.step)
    srv.run_until_drained()
    busy_ms = sum(by_name.values())
    steps = srv.decode_steps
    say("lm_decode_profile", card=card, live_rows=len(prompts),
        model_steps=steps, wall_ms=wall_ms,
        wall_ms_per_model_step=wall_ms / steps,
        kernel_launches_per_model_step=n / steps,
        device_busy_ms=busy_ms if n else "not measured",
        device_busy_share=busy_ms / wall_ms if n else "not measured",
        top_kernels_ms=dict(by_name.most_common(8)))


def phase_lm_exactness(cfg: dict) -> None:
    """Full width, depth 2, f32: a ``kernel`` and a ``plain`` paged pool
    serve the shared-prefix workload; their greedy streams must be
    equal token for token."""
    import torch

    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.utils.lm_bench import (prefix_bench_workload,
                                                 serving_max_new)

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_lm(cfg, "f32", depth=2, seed=1)
    prompts, _, buckets = prefix_bench_workload(cfg, LM_BLOCK)
    max_new = serving_max_new(cfg)
    streams, hits = {}, {}
    for kernel in ("kernel", "plain"):
        srv = DecodeServer(model, paged_kernel=kernel, device="cuda",
                           **lm_pool_kw(cfg, buckets))
        ids = [srv.submit(p, max_new=max_new) for p in prompts]
        done = {c.id: c.tokens for c in srv.run_until_drained()}
        streams[kernel] = [done[i] for i in ids]
        hits[kernel] = srv.prefix_cache_stats()["hits"]
    differ = sum(a != b for sa, sb in zip(streams["kernel"], streams["plain"])
                 for a, b in zip(sa, sb))
    say("lm_exactness", depth=2, dtype="float32", requests=len(prompts),
        tokens_per_stream=len(streams["kernel"][0]), radix_hits=hits,
        tokens_differing=differ)
    if streams["kernel"] != streams["plain"] or hits["kernel"] <= 0:
        raise AssertionError(f"kernel and plain pools differ in {differ} "
                             f"tokens (hits {hits})")
    del model


# -- LM training kernels and path (K4, K5) --------------------------------

# (shape, dtype, causal): the training shape of the full-width LM, a
# smaller f32 causal and non-causal case, a ragged T = 1000, and head_dim
# 32 of the tensor-core K4 and K5
FLASH_BWD_CHECKS = (((8, 1024, 16, 64), "bf16", True),
                    ((2, 512, 8, 64), "f32", True),
                    ((2, 512, 8, 64), "f32", False),
                    ((2, 1000, 4, 64), "bf16", True),
                    ((2, 1000, 4, 32), "bf16", False))
BWD_F32_TOL = 1e-5     # of the reference's largest magnitude


def flash_bwd_inputs(shape, dtype: str, causal: bool, seed: int):
    """q, k, v, dO on the card, and K2's out and lse for them: what the
    backward kernels read in training."""
    import torch

    from idunno_tpu_torch.ops.flash_attention import flash_attention_kernel

    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dt)
                   for _ in range(4))
    out, lse = flash_attention_kernel(q, k, v, causal=causal)
    return q, k, v, do, out, lse


def phase_flash_bwd_vs_plain() -> dict:
    """K4 and K5 against the plain backward on the same inputs (K2's out
    and lse). f32: within 1e-5 of the reference's largest magnitude (both
    sum in f32, in another order). bf16 dQ, dK and dV (K4 and K5 on the
    tensor cores, which round dS, and in K5 Pᵀ, to bf16 before their
    products): each element within ``tensor_core_bound``. Returns the
    largest |difference| of each kernel's outputs."""
    import torch

    from idunno_tpu_torch.ops.flash_attention import (
        attention_delta, flash_attention_bwd_dkv_kernel,
        flash_attention_bwd_dq_kernel, flash_attention_bwd_plain,
        tensor_core_bound)

    kernel_of = {"dq": "flash_attention_bwd_dq",
                 "dk": "flash_attention_bwd_dkv",
                 "dv": "flash_attention_bwd_dkv"}
    worst = dict.fromkeys(kernel_of.values(), 0.0)
    for i, (shape, dtype, causal) in enumerate(FLASH_BWD_CHECKS):
        q, k, v, do, out, lse = flash_bwd_inputs(shape, dtype, causal, 50 + i)
        delta = attention_delta(out, do)
        dq = flash_attention_bwd_dq_kernel(q, k, v, do, lse, delta,
                                           causal=causal)
        dk, dv = flash_attention_bwd_dkv_kernel(q, k, v, do, lse, delta,
                                                causal=causal)
        refs = flash_attention_bwd_plain(q, k, v, out, do, lse, causal=causal)
        torch.cuda.synchronize()
        for name, got, ref in (("dq", dq, refs[0]), ("dk", dk, refs[1]),
                               ("dv", dv, refs[2])):
            g, r = got.float(), ref.float()
            diff = (g - r).abs()
            scale = float(r.abs().max())
            if dtype == "bf16":
                bound = tensor_core_bound(name, got, ref, q, k, v,
                                          causal=causal, do=do, lse=lse,
                                          delta=delta)
                ratio = float((diff.double() / bound).max())
                tol = ("2^-8 (|dS|.|K|) (dq), (|dS|^T.|Q|) (dk) or "
                       "(P^T.|dO|) (dv) + 1 bf16 ulp of max(|got|, |ref|) "
                       "+ 1e-5 x max|ref|, per element")
            else:
                ratio = float(diff.max()) / (BWD_F32_TOL * scale)
                tol = f"{BWD_F32_TOL} x max|ref|"
            say("kernel_vs_plain", kernel=kernel_of[name], output=name,
                shape=list(shape), dtype=dtype, causal=causal,
                max_abs_err=float(diff.max()), max_abs_ref=scale,
                max_err_over_tolerance=ratio, tolerance=tol)
            if not (ratio <= 1.0 and got.dtype == q.dtype
                    and got.shape == q.shape):
                raise AssertionError(f"flash backward {name} off: {ratio} of "
                                     f"its tolerance at {shape} {dtype} "
                                     f"causal={causal}")
            worst[kernel_of[name]] = max(worst[kernel_of[name]],
                                         float(diff.max()))
    return worst


def phase_flash_bwd_timing() -> dict:
    """K4 and K5 at the training shape (bf16 [8, 1024, 16, 64], causal) by
    CUDA-graph replay (``ms``) and by CUDA events over a loop of launches,
    beside their bounds, their plain parts and, as ``library_ms`` of both,
    one call of PyTorch's flash-attention backward
    (``aten::_scaled_dot_product_flash_attention_backward``) on the same
    inputs, timed by graph replay."""
    import torch

    from idunno_tpu_torch.ops.flash_attention import (
        _dkv_plain, _dq_plain, attention_delta,
        flash_attention_bwd_dkv_kernel, flash_attention_bwd_dq_kernel)

    b, t, h, d = shape = (8, 1024, 16, 64)
    q, k, v, do, out, lse = flash_bwd_inputs(shape, "bf16", True, 60)
    delta = attention_delta(out, do)
    kernels = {"flash_attention_bwd_dq": lambda: flash_attention_bwd_dq_kernel(
                   q, k, v, do, lse, delta, causal=True),
               "flash_attention_bwd_dkv": lambda: flash_attention_bwd_dkv_kernel(
                   q, k, v, do, lse, delta, causal=True)}
    ms = {name: graph_ms(fn, 20) for name, fn in kernels.items()}
    events_ms = {name: cuda_ms(fn, 20) for name, fn in kernels.items()}
    plain = {"flash_attention_bwd_dq": cuda_ms(
                 lambda: _dq_plain(q, k, v, do, lse, delta, causal=True), 3),
             "flash_attention_bwd_dkv": cuda_ms(
                 lambda: _dkv_plain(q, k, v, do, lse, delta, causal=True), 3)}
    aten = torch.ops.aten
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    (o_t, lse_t, cq, ck, mq, mk, seed, offset,
     _) = aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, True)
    library_ms = graph_ms(
        lambda: aten._scaled_dot_product_flash_attention_backward(
            dot, qt, kt, vt, o_t, lse_t, cq, ck, mq, mk, 0.0, True, seed,
            offset), 20)
    # each input read once, each output written once; the work is the
    # T(T+1)/2 live (query, key) pairs of each head, 2·D operations per
    # pair and product: K4 has three products (s, dO·Vᵀ, ds·K), K5 four
    # (s, dO·Vᵀ, pᵀ·dO, dsᵀ·Q)
    elems = q.numel()
    pairs = b * h * t * (t + 1) // 2
    rows = 2 * b * h * t * 4                    # lse and delta, f32
    work = {"flash_attention_bwd_dq": (4 * elems * 2 + rows + elems * 2,
                                       3 * 2 * d * pairs),
            "flash_attention_bwd_dkv": (4 * elems * 2 + rows + 2 * elems * 2,
                                        4 * 2 * d * pairs)}
    timing = {}
    for name, (nbytes, flops) in work.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        timing[name] = {"ms": ms[name], "plain_ms": plain[name],
                        "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": "bytes" if bytes_ms >= ops_ms
                        else "operations",
                        "library_ms": library_ms}
        say("timing", kernel=name, shape=list(shape), causal=True,
            **timing[name], events_ms=events_ms[name], bytes=nbytes,
            flops=flops, achieved_tflops=flops / (ms[name] * 1e-3) / 1e12,
            events_tflops=flops / (events_ms[name] * 1e-3) / 1e12,
            timed_by="cuda graph replay (ms), cuda events over 20 "
                     "launches (events_ms)",
            library="aten::_scaled_dot_product_flash_attention_backward "
                    "(dq, dk, dv in one call), cuda graph replay")
    return timing


def grad_agreement(model, tokens) -> dict:
    """Every parameter's gradient of one batch's loss through flash
    (K2, K4, K5) and through ``full`` attention, before any update:
    the smallest cosine and the largest relative difference in norm."""
    import torch

    from idunno_tpu_torch.engine.train_lm import next_token_loss
    from idunno_tpu_torch.models.transformer import make_attn_fn

    grads = {}
    for kind in ("flash", "full"):
        model.set_attn_fn(make_attn_fn(kind))
        model.zero_grad(set_to_none=True)
        ce, _ = next_token_loss(model(tokens), tokens)
        ce.backward()
        grads[kind] = {n: p.grad.detach().clone()
                       for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.set_attn_fn(make_attn_fn("flash"))
    worst_cos, worst_norm, where = 1.0, 0.0, {}
    for name, gf in grads["flash"].items():
        gr = grads["full"][name]
        cos = float(torch.nn.functional.cosine_similarity(
            gf.flatten().double(), gr.flatten().double(), dim=0))
        norm = abs(float(gf.norm() / gr.norm()) - 1.0)
        if cos < worst_cos:
            worst_cos, where["cosine"] = cos, name
        if norm > worst_norm:
            worst_norm, where["norm"] = norm, name
    return {"tensors": len(grads["flash"]), "min_cosine": worst_cos,
            "max_norm_rel_diff": worst_norm, "worst_at": where}


def phase_lm_train(card: str) -> dict:
    """The full-width LM trained on the card through K2, K4 and K5; returns
    the launches of the ten counted steps."""
    import numpy as np
    import torch

    from idunno_tpu_torch.engine.data_lm import TokenDataset
    from idunno_tpu_torch.engine.train import adamw, flat_tx
    from idunno_tpu_torch.engine.train_lm import (create_lm_train_state,
                                                  make_lm_train_step)
    from idunno_tpu_torch.models.transformer import (TransformerLM,
                                                     make_attn_fn)
    from idunno_tpu_torch.utils.train_bench import (H100_BF16_FLOPS,
                                                    lm_flops_per_token,
                                                    run_train_bench,
                                                    train_bench_config)

    cfg = train_bench_config("cuda")
    b, t, depth = cfg["batch"], cfg["seq"], cfg["depth"]
    corpus = np.random.default_rng(0).integers(0, cfg["vocab"],
                                               4 * b * (t + 1))
    block = next(TokenDataset(corpus, t, seed=0).batches(b))
    tokens = torch.from_numpy(block[:, :t]).to("cuda", torch.int64)
    model = TransformerLM(vocab=cfg["vocab"], dim=cfg["dim"], depth=depth,
                          num_heads=cfg["heads"], attn_fn=make_attn_fn("flash"),
                          dtype=torch.float32, compute_dtype=torch.bfloat16)
    state = create_lm_train_state(
        model, torch.Generator(device="cuda").manual_seed(0),
        flat_tx(adamw(3e-4)))
    agree = grad_agreement(model, tokens)
    say("lm_train_grads", card=card, compare="flash_vs_full", **agree,
        tolerance={"min_cosine": 0.999, "max_norm_rel_diff": 0.02})
    if not (agree["min_cosine"] >= 0.999
            and agree["max_norm_rel_diff"] <= 0.02):
        raise AssertionError(f"flash and full gradients disagree: {agree}")

    step = make_lm_train_step(model, state.optimizer)
    torch.cuda.synchronize()
    zero_launches()
    losses, times = [], []
    for _ in range(LM_TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(state, tokens)["loss"]))
        times.append(time.perf_counter() - t0)
    launches = read_launches()
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    n_params = sum(p.numel() for p in model.parameters())
    tok_s = b * t / step_s
    mfu = tok_s * lm_flops_per_token(n_params, cfg) / H100_BF16_FLOPS
    master = sorted({str(p.dtype) for p in model.parameters()})
    say("lm_train", card=card, batch=b, seq=t, depth=depth,
        n_params=n_params, steps=LM_TRAIN_STEPS, losses=losses,
        step_ms_median=step_s * 1e3, first_step_ms=times[0] * 1e3,
        tokens_per_s=tok_s, mfu=mfu, launches=launches,
        master_param_dtypes=master)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss not finite and falling: {losses}")
    for name in ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        if launches[name] != depth * LM_TRAIN_STEPS:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{LM_TRAIN_STEPS} steps of depth {depth}")
    if master != ["torch.float32"]:
        raise AssertionError(f"master parameters are {master}, not f32")

    wall_ms, by_name, n = device_profile(lambda: step(state, tokens))
    busy_ms = sum(by_name.values())
    flash_ms = sum(v for k, v in by_name.items()
                   if "flash_fwd" in k or "flash_bwd" in k)
    say("lm_train_profile", card=card, wall_ms=wall_ms, kernel_launches=n,
        device_busy_ms=busy_ms if n else "not measured",
        device_busy_share=busy_ms / wall_ms if n else "not measured",
        flash_device_ms=flash_ms if n else "not measured",
        flash_share_of_device=flash_ms / busy_ms if n else "not measured",
        top_kernels_ms=dict(by_name.most_common(10)))
    del model, state, step
    torch.cuda.empty_cache()

    rec = run_train_bench()
    say("lm_train_bench", card=card, **rec)
    failed = {k: v for k, v in rec.items()
              if isinstance(v, dict) and "error" in v}
    if failed or "cnn" not in rec or "accum" not in rec:
        raise AssertionError(f"train bench points failed or missing: {failed}")
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is present", file=sys.stderr)
        return 2
    try:
        from idunno_tpu_torch.config import EngineConfig
        from idunno_tpu_torch.engine.inference import InferenceEngine
        from idunno_tpu_torch.utils.lm_bench import lm_bench_config
    except ImportError as e:
        print(f"chip_smoke: the idunno_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    say("start", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda)
    smi = phase_build()
    kind = torch.cuda.get_device_name(0)
    err = {"preprocess": phase_kernel_vs_plain(),
           "flash_attention": phase_flash_vs_plain(),
           "paged_attention": phase_paged_vs_plain(),
           **phase_flash_bwd_vs_plain()}
    timing = {"preprocess": phase_timing(),
              "flash_attention": phase_flash_timing(),
              "paged_attention": phase_paged_timing(),
              **phase_flash_bwd_timing()}
    torch.cuda.empty_cache()

    cfg = dict(batch_size=BATCH, image_size=CROP, resize_size=SIDE)
    engines = {mode: InferenceEngine(EngineConfig(preprocess=mode, **cfg),
                                     seed=0)
               for mode in ("kernel", "plain", "fold")}
    for name in ("resnet", "alexnet"):
        engines["kernel"].warmup(name)
    launches = {"preprocess": phase_serving(engines["kernel"])}
    phase_paths(engines, smi)
    del engines
    torch.cuda.empty_cache()

    lm_cfg = lm_bench_config()
    lm = build_lm(lm_cfg, "bf16", depth=lm_cfg["depth"], seed=0)
    launches["flash_attention"] = phase_lm_prefill(lm, lm_cfg, smi)
    launches["paged_attention"] = phase_lm_serving(lm, lm_cfg, smi)
    del lm
    torch.cuda.empty_cache()
    phase_lm_exactness(lm_cfg)
    torch.cuda.empty_cache()
    train = phase_lm_train(smi)
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        launches[name] = train[name]

    replaces = {"preprocess": "idunno_tpu/ops/pallas_preprocess.py:27",
                "flash_attention": "idunno_tpu/ops/flash_attention.py:71",
                "paged_attention": "idunno_tpu/ops/paged_attention.py:118",
                "flash_attention_bwd_dq": "idunno_tpu/ops/flash_attention.py:113",
                "flash_attention_bwd_dkv":
                    "idunno_tpu/ops/flash_attention.py:147"}
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"idunno_tpu_torch/csrc/{source}.cu",
        "replaces": replaces[name],
        "launches": launches[name],
        "max_abs_err": err[name],
        **timing[name]} for name, source in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
