#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``idunno_tpu_torch``) on one NVIDIA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``idunno_tpu_torch/csrc/`` with
``nvcc`` (all sources at once), holds each against its plain PyTorch
version, times it, and then drives the port's main paths, in process and
then as a cluster of nodes (``python -m idunno_tpu_torch``) driven
through the control RPC:

- CNN serving: ResNet-18 and AlexNet at full width (224² crops of 256²
  images, engine batch 256, seeded random weights) served by an
  in-process cluster of three hosts (membership, fair scheduler,
  inference service) around one engine on the card — kernel K1; then
  ResNet-18 with int8 weights and with the space-to-depth stem, and
  ViT-S/16 (dim 384, depth 12, 6 heads, 197 tokens) served by the engine
  through K1 and the flash kernel K2;
- LM serving: the 0.2 B-parameter ``TransformerLM`` (dim 1024, depth 12,
  16 heads, vocab 32768, bf16, seeded random weights) — its full forward
  prefill through the flash kernel K2, and a continuous-batching
  ``DecodeServer`` with the paged KV block pool and radix prefix cache,
  driven by ``LMServingLoop`` from two request threads, attending cached
  prefixes through the paged kernel K3, each all-greedy decode dispatch
  replayed as one CUDA graph (and once eagerly beside it), with the bf16
  weights and with int8 ones, plain and speculative (a draft proposes 4
  tokens a round, the target verifies them through K3); beam search;
  and the JAX package's default-size model (head_dim 32) in a paged pool
  through K3;
- LM training: the same 0.2 B-parameter model with f32 master parameters
  and bf16 compute, trained on seq 1024 × batch 8 by the port's LM train
  step (next-token cross-entropy, fused AdamW), attending through the
  flash forward K2 and the flash backward kernels K4 (dQ) and K5 (dK, dV)
  joined in one ``torch.autograd.Function``; then the train bench
  (``utils/train_bench.py``: the LM, gradient-accumulation and ResNet-18
  points);
- the bench and the profiler: ``python -m idunno_tpu_torch.bench`` (the
  ``lm`` and ``lm_prefix`` suites of ``utils/lm_bench.py``) at full
  width through K2-K5, ``utils/tracing.py``'s ``device_timed`` on
  replayed decode dispatches, and the cluster's ``profile`` verb tracing
  a node while its LM pool serves;
- tensor-parallel decode: the same LM in a paged pool sharded over a
  virtual mesh of the card at n_model 2 and 4 (K3 per model shard on its
  16 / n_model KV heads, head-sharded block stores, the vocab-sharded
  sampling tail), held to n_model 1;
- the routed FFN (switch MoE): the same LM widths with a switch FFN of 8
  experts on every other block (570,884,144 parameters, seeded): its
  prefill through K2, its training through K2, K4 and K5 (``remat`` held
  to none), and its serving from a gathered block pool, replayed.

Phases:

1. card and build: the card's name and power limit, ``-Xptxas -v``
   (a spill in the bf16 tensor-core kernels, K2, K4 and K5, fails the
   run);
2. every kernel against its plain version, at the main paths' shapes
   (bf16 K2, K4 and K5 within the per-element bound of their bf16
   rounding of P and dS, ``ops/flash_attention.py:tensor_core_bound``;
   K2 also at ViT-S/16's [256, 197, 6, 64]; K3 also at head_dim 32, at
   the speculative verify shape, 16 rows x 5 positions, and at one
   tensor-parallel shard's decode shape, 16 / n_model KV heads);
3. kernel timing by CUDA-graph replay (K4 and K5 also by CUDA events; K2
   also at the ViT shape, non-causal; K3 at the decode, the radix-hit
   prefill, the head_dim 32 decode and the verify shapes), beside its bound, the
   plain time and, where one exists, one PyTorch library call computing
   the same function;
4. CNN serving: concurrent ``resnet`` and ``alexnet`` queries of 1024
   images each; every record must come back, no engine error may be
   reported, and the K1 launch count, zeroed just before, must rise;
5. CNN preprocess paths on the same weights: ``kernel`` logits against
   ``plain`` and ``fold``, the card's logits against an f32 CPU reference
   on 8 images, and each path's images/s; then ResNet-18 with int8
   weights (logits against the same engine on its dequantized weights)
   and with the space-to-depth stem (against the 7x7 stem), images/s,
   and the int8 weights' stored bytes;
6. ViT serving: a 1024-image query through ViT-S/16; every record comes
   back, K2 launches (zeroed just before) equal 12 x the forward batches,
   K1 launches rise; flash logits against ``full`` attention on the same
   weights (bf16 within 2% of max|logit|; in f32, K2's f32 variant, top-1
   equal on at least 99%), the card against an f32 CPU reference on 8
   images; images/s; one forward under ``torch.profiler``;
7. LM prefill: the full-width forward on [4, 1024] tokens through
   ``make_attn_fn("auto")``; K2 launches must equal depth × forwards, and
   the logits must agree with the ``full`` attention forward; one forward
   under ``torch.profiler`` gives K2's share of the device time;
8. LM serving: 48 shared-prefix prompts from two threads, each
   all-greedy dispatch replayed as one CUDA graph; every request
   completes with prompt + max_new in-vocab tokens, radix hits > 0, K3
   launches (zeroed just before; a replay adds the launches its capture
   recorded) > 0, dispatches replayed, no loop errors; tokens/s, TTFT,
   ms a model step, and one dispatch under ``torch.profiler`` (host
   launch calls, device busy share); replayed dispatches timed by
   ``utils/tracing.py:device_timed`` within 20% of CUDA events around the
   same calls (the first call flagged not warm); the same prompts
   eagerly beside it;
   then 32 of them with int8 weights (``quantize="int8"``), with the
   resident weight bytes against the bf16 pool's; then (b) speculative
   serving with the JAX bench's draft (dim 256, depth 2, 4 heads,
   draft_len 4): every request completes, tokens/s, tokens committed a
   round, K3 launches; (c) the bench's mechanism ceiling (zeroed target
   and draft, acceptance 1.0): every round commits draft_len + 1 tokens,
   tokens/s beside the plain pool's; beam search: width 1 equals greedy
   ``generate`` (f32, depth 2), the full-width time for batch 4, width
   4, 32 new tokens;
9. the bench (``bench``): ``python -m idunno_tpu_torch.bench`` as a
   subprocess for ``BENCH_SUITE=lm`` (compact: prefill through K2, the
   flash backward through K4 and K5, steady decode of 128-step replayed
   dispatches from the contiguous cache and, in its ``paged_k3`` arm,
   through K3) and ``lm_prefix`` (radix cache on and off, and on through
   K3) at
   full width: each exits 0 with one JSON line, a value, no error,
   provenance naming this card, K3 launches > 0 (K2 > 0 for ``lm``), a
   ``paged_k3`` arm beside the headline (which serves from the JAX
   suite's pool: contiguous for ``lm``, gathered for ``lm_prefix``), and
   a prefill-token ratio below 1 for ``lm_prefix``; their launches count
   on the ``kernels`` line;
10. LM token exactness: the same workload at full width, depth 2, f32,
   with dense and with int8 weights: paged pools with K3 replayed, K3
   eager and the plain paged attention eager, and a contiguous pool
   replayed and eager: equal greedy streams within each; (a) speculative
   pools (the bench's draft replayed and eager, the target as its own
   draft) against the plain pool: equal streams; then the default-size
   model (dim 128, 4 heads: head_dim 32) on a ``kernel`` and a
   ``plain`` pool: equal streams, K3 launches > 0;
11. the cluster (``cluster``): nodes n0, n1, n2 built as ``python -m
    idunno_tpu_torch`` builds them (``__main__.build_node``: a
    ``NetTransport`` on free local ports, engines at batch 256, 224², on
    the card), driven through ``comm.net.oneshot_call`` only: n0
    publishes ResNet-18's seeded weights, then ``inference`` verbs
    (resnet at n2, alexnet at n1, 1,024 images each) run twice, cold and
    warm: every record comes back, n1 and n2 serve resnet with provenance
    "store", K1 launches rise; the full-width bf16 LM is ``put`` into the
    store as a blob file and ``lm_serve``d with phase 8's pool: the 48
    requests from two client threads through ``lm_submit``/``lm_poll``
    complete, K3 launches > 0, radix hits, dispatches replayed; tokens/s
    and TTFT through the RPC beside phases 4 and 8's in-process figures;
    the ``profile`` verb traces n0 for 2 s while the pool serves the
    requests again, and its Chrome trace must hold K3 kernels;
    ``generate`` through the verb equals this process's; the f32 depth-2
    pool through the verbs equals an in-process pool token for token;
    then (``cluster_kv``, K3) on the same nodes, the stored bf16 LM in
    pools with the cluster prefix cache and a 512-token bucket: kv1 on n1
    serves the 48 requests and publishes chains; kv2 on n2 probes them
    (same namespace, no local and ≥ 3 remote blocks), its first admission
    prefills one suffix bucket, and the other 47 complete with remote
    hits; kv3 on n0 warms from the tenant index before any request;
    ``kv_handoff`` ``ship`` of four 512-token prompts from kv1 to kv2,
    whose admissions of them prefill one suffix bucket each, with no
    fallback; blocks, bytes and seconds of each leg, K3 launches > 0; (e)
    f32 depth 2, for K3 and the plain paged attention: pools fed by remote
    hits and by adopted handoffs give the greedy streams of pools that
    prefilled themselves; then (``cluster_train``) a training job of the
    full-width LM at depth 4 (f32 parameters, bf16 compute, seq 1024 x
    batch 8, 12 steps, a checkpoint every 4) from a seeded 2M-token corpus
    in the store: ``train_start`` on n1, ``train_stop`` after its first
    checkpoint, ``train_start(resume=True)`` on n2 to the end (the loss
    finite and falling, the LM published), ``generate`` of it through n0
    equal to this process's; step ms, each checkpoint's bytes and seconds;
    and a full-depth job, whose 2.62 GB train state is over the store's
    2 GiB frame, ends in a typed error naming the cap; then ``python -m
    idunno_tpu_torch --host n0 --no-shell`` as a subprocess, without
    ``--cpu``: ``put`` and greedy ``generate`` equal to this process's,
    the subprocess seen among the card's compute apps;
12. tensor-parallel decode (``tp_decode``): the full-width LM in a paged
    pool on a virtual mesh of the card (every model shard on cuda:0), at
    n_model 2 and 4 against n_model 1: in f32 (K3 on f32 pages, TF32
    off) 8 shared-prefix requests' greedy streams and a seeded sampled
    stream equal n_model 1's token for token, with radix hits, replayed
    dispatches and K3 launches of exactly n_model times n_model 1's; in
    bf16, n_model 1's streams teacher-forced through each tensor-parallel
    decoder give logits within ``TP["bf16_rel_tol"]`` (5%) of n_model
    1's, relative to each row's largest |logit|; the share of greedy
    tokens a bf16 TP pool serves differently and each pool's decode
    tokens/s are printed, not gated;
13. LM training (``lm_train``): one batch from a ``TokenDataset`` over a
    seeded corpus; the gradients of every parameter through flash and
    through ``full`` attention agree (cosine ≥ 0.999, norms within 2%);
    ten steps on that batch with finite, falling loss, K2, K4 and K5
    launches (zeroed just before) each equal to depth × 10, and f32
    master parameters after; one step under ``torch.profiler``; then the
    train bench's record, with no point in error;
14. the routed FFN (``models/moe.py``, ``MOE``): ``moe_prefill``, the
    full-width routed forward on [4, 1024] tokens, bf16, through
    ``make_attn_fn("auto")``: K2 launches (zeroed just before) equal
    depth × forwards, logits within 2% of the ``full`` forward's largest,
    the share of routing decisions the two take differently, tokens/s;
    ``moe_train``, f32 parameters, bf16 compute, seq 1024 × batch 8: at
    depth 2 flash and ``full`` gradients agree (cosine ≥ 0.999, f32) and
    ``remat=True`` gives the same loss and gradients within 1e-5 of the
    largest (K2 twice a block: forward and recompute); at full width
    ``MOE_TRAIN_STEPS`` steps on one batch with finite, falling loss, a
    finite balance loss, K2/K4/K5 launches of depth × steps, step ms,
    tokens/s, MFU over the active parameters, and the dispatch einsums'
    share of the step's device time; ``moe_serving``, bf16, 16 slots, a
    gathered block pool: a ``paged_kernel`` pool raises, replayed and
    eager pools give equal greedy streams, then the 48 shared-prefix
    prompts from two threads: tokens/s, TTFT p50/p95;
15. ``failed_capture``: after a provoked failed CUDA-graph capture the
    pool serves a sampled request equal to an eager pool's, and a random
    draw on the card succeeds;
16. one JSON line ``{"kernels": [...]}``, each kernel's ``launches`` the
    sum over the paths it runs on;
17. the last line, ``{"ok": true, "device": {...}}``.

Every ``torch.profiler`` window (``device_profile``) prints a
``profile_window`` line: when it opened after the previous window
closed, the CUDA activities Kineto returned, the kernels recorded and
those the window's labels matched.

Any failure raises, and the script exits non-zero without the last line.
It also exits non-zero when no CUDA card is present, or when the package
is not beside it.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import random
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
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
LM_INT8_REQUESTS = 32            # requests of the int8-weight serving run
LM_DRAFT_LEN = 4                 # proposals a speculative round
# the JAX LM bench's draft (``idunno_tpu/utils/lm_bench.py:75-77``)
LM_DRAFT = {"dim": 256, "depth": 2, "heads": 4}
BEAM = {"batch": 4, "width": 4, "max_new": 32}
# the routed FFN of the MoE phases: Switch-Base-8's eight experts on every
# other block (the Switch-Transformer interleave, idunno_tpu/models/
# moe.py:14-15), capacity factor 2, top-1, hidden 4 x dim
MOE = {"n_experts": 8, "capacity_factor": 2.0, "hidden_ratio": 4, "k": 1,
       "moe_every": 2}
# the full-width routed LM: the dense 218,298,368 plus, on each of the six
# routed blocks, 8 experts and a router in place of one dense MLP
MOE_PARAMS = 218_298_368 + 6 * (67_158_024 - 8_393_728)
MOE_TRAIN_STEPS = 6              # routed train steps on one batch
# the tensor-parallel decode phase: the full-width LM on a virtual mesh of
# the card (every model shard on cuda:0) at these model-axis extents,
# against n_model 1; the bf16 gate bounds the largest logit difference of
# a teacher-forced stream, relative to the row's largest |logit|
TP = {"n_models": (2, 4), "requests": 8, "max_new": 32, "seed": 5,
      "bf16_rel_tol": 0.05}
CLUSTER_HOSTS = ("n0", "n1", "n2")
CLUSTER_GEN = {"prompts": 4, "max_new": 16}   # the cluster's `generate`
# the in-process serving figures of phases 4 and 8, printed beside the
# cluster's figures through the RPC
IN_PROCESS: dict = {}


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


def zero_launches() -> None:
    from idunno_tpu_torch.ops.launches import zero_launches as zero
    zero()


def read_launches() -> dict:
    from idunno_tpu_torch.ops.launches import read_launches as read
    return read()


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
    IN_PROCESS["images_per_s"] = 2 * N_QUERY / wall
    return launches


def staged_rates(engines: dict, name: str, staged, n: int,
                 turns: list[str]) -> dict:
    """images/s of ``infer_staged`` on one staged block, the engines taken
    in ``turns`` (each warmed first): mode → sorted rates."""
    rates = {mode: [] for mode in engines}
    for eng in engines.values():
        eng.infer_staged(name, staged, n)                  # warm
    for mode in turns:
        t0 = time.time()
        engines[mode].infer_staged(name, staged, n)
        rates[mode].append(n / (time.time() - t0))
    return {mode: sorted(r) for mode, r in rates.items()}


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
        rates = staged_rates(engines, name, staged, n, turns)  # warms
        infer = {mode: N_QUERY / eng.infer(name, 0, N_QUERY - 1).elapsed_s
                 for mode, eng in engines.items()}
        for mode, r in rates.items():
            say("paths", model=name, preprocess=mode, card=card,
                infer_images_per_s=infer[mode],
                staged_images_per_s_median=(r[3] + r[4]) / 2,
                staged_images_per_s_min=r[0], staged_images_per_s_max=r[-1])


# -- LM kernels and paths (K2, K3) ----------------------------------------

# bf16 (the tensor-core kernel): the prefill shape causal and not, the
# training shape, a ragged T = 1000, head_dim 32, and ViT-S/16's attention
# at the engine batch (T = 197 non-causal: 5 live rows in the last tile)
VIT_SHAPE = (BATCH, 197, 6, 64)
FLASH_CHECKS = (((4, 1024, 16, 64), True), ((4, 1024, 16, 64), False),
                ((8, 1024, 16, 64), True), ((4, 1000, 16, 64), True),
                ((4, 1000, 16, 32), False), (VIT_SHAPE, False))


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


def paged_inputs(*, b, t, kvh, g, d, n, bs, chains, int8, seed, layers=None,
                 dtype="bf16"):
    """Decode-pool inputs: f32 queries, pages (``dtype``, "bf16" or "f32",
    or int8 with f32 per-token scales; ``layers`` stacks that many
    layers' stores), tables whose live entries are distinct pages and
    dead entries 0, and block-aligned lengths ``chains[b] * bs``."""
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
                  .to({"f32": torch.float32, "bf16": torch.bfloat16}[dtype])
                  for _ in range(2))
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
    (16 slots, 16 kv-heads, bs 16, chains of 0-3 blocks, row 0 empty), a
    radix-hit prefill (one row, 64 query positions, a 3-block chain), the
    default-size model's decode shape (head_dim 32, 4 kv-heads), and the
    speculative verify of draft_len 4 (16 rows x 5 positions) at head_dim
    64 (16 kv-heads) and 32 (4 kv-heads); and the decode shape of one
    model shard of the tensor-parallel pool (16 / n_model kv-heads)."""
    rng = random.Random(3)
    chains = [0] + [rng.randint(0, 3) for _ in range(15)]
    t = LM_DRAFT_LEN + 1
    return (("decode", dict(b=16, t=1, kvh=16, g=1, d=64, n=68, bs=LM_BLOCK,
                            chains=chains)),
            ("hit_prefill", dict(b=1, t=64, kvh=16, g=1, d=64, n=68,
                                 bs=LM_BLOCK, chains=[3])),
            ("decode_d32", dict(b=16, t=1, kvh=4, g=1, d=32, n=68,
                                bs=LM_BLOCK, chains=chains)),
            ("verify", dict(b=16, t=t, kvh=16, g=1, d=64, n=68, bs=LM_BLOCK,
                            chains=chains)),
            ("verify_d32", dict(b=16, t=t, kvh=4, g=1, d=32, n=68,
                                bs=LM_BLOCK, chains=chains)),
            # one model shard of the tensor-parallel pool: 16 KV heads
            # over n_model 2 and 4
            *((f"decode_tp{n}", dict(b=16, t=1, kvh=16 // n, g=1, d=64,
                                     n=68, bs=LM_BLOCK, chains=chains))
              for n in TP["n_models"]))


def phase_paged_vs_plain() -> float:
    """K3 against its plain version at the decode, hit-prefill, head_dim
    32 decode and speculative verify shapes, f32, bf16 and int8 pages: out and lse
    within 1e-5 relative; empty chains exactly (0, -1e30). Returns the
    largest |out difference|."""
    import torch

    from idunno_tpu_torch.ops.paged_attention import (_paged_plain,
                                                      paged_attention_kernel)

    worst = 0.0
    for label, dims in paged_shapes():
        for i, pages in enumerate(("f32", "bf16", "int8")):
            q5, kp, vp, tables, lengths, ks, vs = paged_inputs(
                int8=pages == "int8", dtype=pages, seed=20 + i, **dims)
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
                head_dim=dims["d"], pages=pages, max_abs_err=diff,
                tolerance=tol, lse_max_rel_err=lse_err, lse_tolerance=1e-5,
                empty_rows=int(empty.sum()), empty_rows_exact=exact_empty)
            if not (diff <= tol and lse_err <= 1e-5 and exact_empty):
                raise AssertionError(f"paged kernel off at {label} "
                                     f"{pages}: out {diff}, lse {lse_err}")
            worst = max(worst, diff)
    return worst


def phase_flash_timing() -> dict:
    """K2 (bf16) at the prefill shape [4, 1024, 16, 64] (causal), whose
    numbers it returns, at the training shape [8, 1024, 16, 64] (causal)
    and at ViT-S/16's shape [256, 197, 6, 64] (non-causal), against its
    bound, its plain version and ``scaled_dot_product_attention``. The
    kernel is timed by graph replay: a launch takes about as long on the
    card as its Python wrapper takes to enqueue it."""
    import torch.nn.functional as F

    from idunno_tpu_torch.ops.flash_attention import (flash_attention_kernel,
                                                      flash_attention_plain)

    timed = {}
    for shape, causal in (((4, 1024, 16, 64), True),
                          ((8, 1024, 16, 64), True), (VIT_SHAPE, False)):
        b, t, h, d = shape
        q, k, v = flash_inputs(shape, 30)
        kernel_ms = graph_ms(
            lambda: flash_attention_kernel(q, k, v, causal=causal), 50)
        plain_ms = cuda_ms(
            lambda: flash_attention_plain(q, k, v, causal=causal), 10)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 50)
        # q, k, v read once and out written once; the work is the live
        # (query, key) pairs, T(T+1)/2 causal or T² not, two D-long
        # products each
        nbytes = 4 * q.numel() * q.element_size()
        pairs = t * (t + 1) // 2 if causal else t * t
        flops = 2 * 2 * b * h * d * pairs
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        timed[shape] = {"ms": kernel_ms, "plain_ms": plain_ms,
                        "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": "bytes" if bytes_ms >= ops_ms
                        else "operations",
                        "library_ms": library_ms}
        say("timing", kernel="flash_attention", shape=list(shape),
            causal=causal, **timed[shape], bytes=nbytes, flops=flops,
            timed_by="cuda graph replay",
            achieved_tflops=flops / (kernel_ms * 1e-3) / 1e12)
    return timed[(4, 1024, 16, 64)]


def phase_paged_timing() -> dict:
    """K3 at the served decode shape (16 rows, 15 with a 3-block chain as a
    radix hit of 48 tokens gives, one empty), whose numbers it returns,
    at the radix-hit prefill shape (one row, 64 query positions, a
    3-block chain), at the default-size model's decode shape (head_dim
    32, 4 kv-heads), and at the speculative verify shape (16 rows x 5
    positions, 16 kv-heads), bf16 pages. The pages of 12 layers rotate as in a
    decode step (54 MB at head_dim 64, above the 50 MB L2), so each launch
    reads its pages from device memory; at head_dim 32 the 12 layers'
    pages (3.3 MB) stay in L2, as that small model's would."""
    from idunno_tpu_torch.ops.paged_attention import (_paged_plain,
                                                      paged_attention_kernel)

    layers, bs = 12, LM_BLOCK
    timed = {}
    for label, b, t, kvh, d, chains in (
            ("decode", 16, 1, 16, 64, [0] + [3] * 15),
            ("hit_prefill", 1, 64, 16, 64, [3]),
            ("decode_d32", 16, 1, 4, 32, [0] + [3] * 15),
            ("verify", 16, LM_DRAFT_LEN + 1, 16, 64, [0] + [3] * 15)):
        q5, kp, vp, tables, lengths, _, _ = paged_inputs(
            b=b, t=t, kvh=kvh, g=1, d=d, n=68, bs=bs, chains=chains,
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
        say("timing", kernel="paged_attention", shape=label, head_dim=d,
            **timed[label],
            bytes=nbytes, flops=flops, live_tokens=live,
            host_loop_ms=host_loop_ms, timed_by="cuda graph replay")
    return timed["decode"]


def build_lm(cfg: dict, dtype, depth: int, seed: int, zero: bool = False):
    """The full-width TransformerLM on the card, seeded with flax's
    initialisers (every weight zero with ``zero``)."""
    import torch

    from idunno_tpu_torch.models.init import init_like_flax
    from idunno_tpu_torch.models.transformer import TransformerLM

    with torch.device("cuda"):
        model = TransformerLM(vocab=cfg["vocab"], dim=cfg["dim"], depth=depth,
                              num_heads=cfg["heads"], dtype=torch.float32)
    init_like_flax(model, torch.Generator(device="cuda").manual_seed(seed))
    if zero:
        for prm in model.parameters():
            prm.data.zero_()
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


def weight_bytes(model) -> int:
    """Bytes of a dense model's parameters as they are held."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


def phase_lm_serving(model, cfg: dict, card: str, quantize: str = "none",
                     n_requests: int | None = None,
                     decode_graph: str = "auto", draft=None) -> int:
    """The shared-prefix prompts (all 48, or the first ``n_requests``)
    from two threads through an LMServingLoop around the full-width paged
    DecodeServer, with the model's weights or (``quantize="int8"``) an
    int8 copy of them, each all-greedy dispatch replayed as one CUDA graph
    (``decode_graph="auto"`` on the card) or run eagerly, plain or with a
    ``draft`` model (``LM_DRAFT_LEN`` proposals a round, LM_DECODE_STEPS
    rounds a dispatch); returns K3's launches."""
    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.ops.quantize import quantized_bytes
    from idunno_tpu_torch.utils.lm_bench import (prefix_bench_workload,
                                                 serving_max_new)

    prompts, shared, buckets = prefix_bench_workload(cfg, LM_BLOCK)
    prompts = prompts[:n_requests]
    max_new = serving_max_new(cfg)
    spec = {} if draft is None else dict(draft=(draft, None),
                                         draft_len=LM_DRAFT_LEN)
    srv = DecodeServer(model, paged_kernel="auto", device="cuda",
                       quantize=quantize, decode_graph=decode_graph,
                       **spec, **lm_pool_kw(cfg, buckets))
    dense_bytes = weight_bytes(model)
    resident = (quantized_bytes(srv.model)[0] if quantize == "int8"
                else dense_bytes)
    warm_s = srv.warmup()
    run, stats = loop_serve(srv, prompts, max_new, cfg)
    launches, hits = run["paged_launches"], run["radix_hits"]
    if hits <= 0 or launches <= 0:
        raise AssertionError(f"radix hits {hits}, K3 launches {launches}")
    steps = stats["dispatches"] * LM_DECODE_STEPS
    # every radix-hit prefill attends its hit through K3 once per layer
    prefill_launches = hits * model.depth
    graph = srv.graph_stats()
    if graph["mode"] == "graph" and graph["replayed"] <= 0:
        raise AssertionError(f"no dispatch was replayed: {graph}")
    if (quantize, draft, decode_graph, n_requests) == ("none", None, "auto",
                                                      None):
        IN_PROCESS.update({k: run[k] for k in ("tokens_per_s", "ttft_p50_s",
                                               "ttft_p95_s")})
    say("lm_serving", card=card, quantize=quantize, requests=run["requests"],
        decode_graph=graph["mode"],
        speculative_draft_len=srv.stats()["config"]["speculative_draft_len"],
        dispatches_replayed=graph["replayed"],
        dispatches_eager=graph["eager"],
        graph_pool_bytes=graph["graph_pool_bytes"],
        launches_per_replay=graph["launches_per_replay"],
        max_new=max_new, resident_weight_bytes=resident,
        weights_plus_graph_pool_bytes=resident + graph["graph_pool_bytes"],
        dense_weight_bytes=dense_bytes,
        dense_weight_dtype=str(next(model.parameters()).dtype),
        decode_steps_per_dispatch=LM_DECODE_STEPS, warmup_s=warm_s,
        **{k: v for k, v in run.items() if k != "requests"},
        decode_model_steps=steps,
        wall_ms_per_model_step=run["wall_s"] * 1e3 / steps,
        radix_lookups=stats["prefix_cache"]["lookups"],
        paged_launches_in_hit_prefills=prefill_launches,
        paged_launches_per_decode_step=(launches - prefill_launches) / steps,
        prefill_tokens=stats["prefill_tokens"])
    profile_dispatch(srv, prompts[:cfg["slots"]], max_new, card)
    if graph["mode"] == "graph" and quantize == "none" and draft is None:
        time_dispatch(srv, prompts[:cfg["slots"]], max_new, card)
    return launches


def time_dispatch(srv, prompts, max_new: int, card: str) -> None:
    """Replayed decode dispatches (every slot live) timed in turns by
    CUDA events around ``srv.step()`` and by ``utils/tracing.py:
    device_timed(srv.step)``: the first timed call must be flagged not
    warm, the later ones warm, every dispatch replayed, and the warm
    figures' median within 20% of the events' median."""
    import statistics

    import torch

    from idunno_tpu_torch.utils.tracing import device_timed

    for p in prompts:
        srv.submit(p, max_new=max_new)
    srv.step()                             # admissions + one dispatch
    replays0 = srv.graph_stats()["replayed"]
    timed = device_timed(srv.step)
    _, first = timed()
    warm, events = [], []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        srv.step()
        end.record()
        torch.cuda.synchronize()
        events.append(start.elapsed_time(end) / 1e3)
        _, t = timed()
        if not t.compiled:
            raise AssertionError("device_timed flagged a repeated call of "
                                 "the same step as not warm")
        warm.append(t.seconds)
    replayed = srv.graph_stats()["replayed"] - replays0
    srv.run_until_drained()
    ratio = statistics.median(warm) / statistics.median(events)
    say("lm_device_timed", card=card, first_call_warm=first.compiled,
        first_call_s=first.seconds, warm_s=warm, cuda_event_s=events,
        warm_over_events=ratio, dispatches_replayed=replayed,
        tolerance=0.2)
    if first.compiled or replayed != 7 or not abs(ratio - 1) <= 0.2:
        raise AssertionError(f"device_timed: first call warm "
                             f"{first.compiled}, {replayed} of 7 "
                             f"dispatches replayed, warm/events {ratio}")


# the bench runs of the `bench` phase: (BENCH_SUITE, extra environment)
BENCH_RUNS = (("lm", {"BENCH_LM_COMPACT": "1"}), ("lm_prefix", {}))


def phase_bench(card: str) -> dict:
    """``python -m idunno_tpu_torch.bench`` as a subprocess for each of
    ``BENCH_RUNS`` at full width: each must exit 0 with exactly one JSON
    line on stdout, a non-null value, no ``error`` anywhere, provenance
    naming this card, K3 launches > 0 (K2 > 0 for ``lm``) and, for
    ``lm_prefix``, a radix prefill-token ratio below 1. Returns the
    kernels' launches summed over the runs."""
    import torch

    from idunno_tpu_torch.bench import find_errors

    launches = dict.fromkeys(KERNELS, 0)
    root = os.path.dirname(os.path.abspath(__file__))
    for suite, extra in BENCH_RUNS:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("BENCH_")}
        env.update(BENCH_SUITE=suite, **extra)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "idunno_tpu_torch.bench"], cwd=root,
            env=env, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or len(lines) != 1:
            raise AssertionError(
                f"bench {suite}: exit {proc.returncode}, {len(lines)} "
                f"stdout lines: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        rec = json.loads(lines[0])
        details = rec.get("details", {})
        errors = find_errors(details) + ([rec["error"]] if "error" in rec
                                         else [])
        prov = details.get("provenance", {})
        if (rec["value"] is None or errors
                or prov.get("device_name") != torch.cuda.get_device_name(0)
                or prov.get("nvidia_smi") != card):
            raise AssertionError(f"bench {suite}: value {rec['value']}, "
                                 f"errors {errors}, provenance {prov}")
        got = details["launches"]
        want = ["paged_attention"] + (["flash_attention"] if suite == "lm"
                                      else [])
        if any(got[k] <= 0 for k in want):
            raise AssertionError(f"bench {suite}: launches {got}")
        if suite == "lm_prefix" and not details["prefill_tokens_ratio"] < 1:
            raise AssertionError(f"bench lm_prefix: prefill token ratio "
                                 f"{details['prefill_tokens_ratio']}")
        # the headline on the JAX suite's pool, K3 in its own arm
        if "tokens_per_s" not in details.get("paged_k3", {}):
            raise AssertionError(f"bench {suite}: no K3 arm: "
                                 f"{details.get('paged_k3')}")
        for name, n in got.items():
            launches[name] += n
        fields = ({"decode": details["decode"],
                   "prefill": details["prefill"],
                   "flash_bwd": details["flash_bwd"],
                   "paged_k3": details["paged_k3"]} if suite == "lm" else
                  {k: details[k] for k in ("cache_on", "cache_off",
                                           "speedup_vs_off",
                                           "prefill_tokens_ratio",
                                           "paged_k3")})
        say("bench", card=card, suite=suite, metric=rec["metric"],
            value=rec["value"], unit=rec["unit"], seconds=seconds,
            wall_s=details["wall_s"], launches=got, **fields)
    return launches


# the host's calls that put work on the card: kernels one by one, or a
# whole captured graph
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


# every device_profile window: its index and when the previous one closed
# (host clock, ns), for the window record each call prints
_WINDOWS = {"count": 0, "last_exit_ns": None}


def device_profile(fn, host: dict | None = None, labels: tuple = ()):
    """``fn`` once under ``torch.profiler`` (through ``utils/tracing.py:
    trace``, so no other trace of the process may overlap it), after a
    synchronize: (its wall ms, a Counter of device ms by kernel name, the
    number of kernels the profiler recorded). The counter is empty where it records none. User
    annotations on the device timeline (the optimizer's
    ``Optimizer.step#...`` range) span kernels already counted and are
    left out. ``host``, where given, receives ``launch_calls``: the
    host's kernel and graph launch calls (``LAUNCH_CALLS``) the profiler
    recorded, and ``kernel_counts``: a Counter of the kernels it recorded
    by full name (those inside a replayed graph included), and
    ``last_kernel_end_before_sync_us``: how long before the synchronize
    after ``fn`` returned its last kernel ended, on the profiler's clock
    (the margin the profiling window had before ``trace`` padded it), and
    ``labelled_ms``: for each of ``labels``, the device ms of the kernels
    launched inside its ``record_function`` ranges (``forward``) and of
    those the autograd engine launched for the nodes the ops inside them
    recorded (``backward``, matched by sequence number).

    Every call prints one ``profile_window`` line: when the window opened
    against the close of the previous one (host clock; ``trace`` pads a
    CUDA window by ``TRACE_PAD_S`` on each side), how many CUDA activities
    Kineto returned, how many kernels the profiler's events hold and how
    many of those the ``labels`` matched, and, for a window that recorded
    no kernel, "not measured" beside those numbers."""
    import collections

    import torch
    from torch.autograd import DeviceType

    from idunno_tpu_torch.utils.tracing import TRACE_PAD_S, trace

    torch.cuda.synchronize()
    enter_ns = time.time_ns()
    with trace(None) as prof:
        t0 = time.perf_counter()
        region_ns = time.time_ns()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        synced_ns = time.time_ns()
    exit_ns = time.time_ns()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    activities = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
    prev = _WINDOWS["last_exit_ns"]
    _WINDOWS["count"] += 1
    _WINDOWS["last_exit_ns"] = exit_ns
    say("profile_window", window=_WINDOWS["count"],
        opened_after_previous_close_ms=(
            (enter_ns - prev) / 1e6 if prev is not None else "first window"),
        region_after_open_ms=(region_ns - enter_ns) / 1e6,
        trace_pad_s=TRACE_PAD_S, wall_ms=wall_ms,
        kineto_cuda_activities=len(activities), kernels=len(kernels),
        labels=list(labels),
        labelled_kernels=(sum(labelled_kernel_count(events, label)
                              for label in labels) if labels else None),
        device="not measured" if not kernels else "recorded")
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    if host is not None:
        host["launch_calls"] = sum(
            e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS
            for e in events)
        host["kernel_counts"] = collections.Counter(e.name for e in kernels)
        ends = [e.end_ns() for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA]
        host["last_kernel_end_before_sync_us"] = (
            (synced_ns - max(ends)) / 1e3 if ends else "not measured")
        host["labelled_ms"] = {label: labelled_device_ms(events, label)
                               for label in labels}
    return wall_ms, by_name, len(kernels)


def labelled_ops(events, label: str) -> tuple[list, list]:
    """The ops inside the ``label`` ranges of ``events`` (and below them),
    and the autograd engine's evaluations of their backward nodes (and
    below them); a kernel is listed under the operator that launched it,
    the labelled range itself under user annotations."""
    from torch.autograd import DeviceType

    def below(roots) -> list:
        out, stack = [], list(roots)
        while stack:
            e = stack.pop()
            if not getattr(e, "is_user_annotation", False):
                out.append(e)
            stack.extend(e.cpu_children)
        return out

    forward = below(e for e in events if e.name == label
                    and e.device_type == DeviceType.CPU)
    seqs = {e.sequence_nr for e in forward if e.sequence_nr >= 0}
    backward = below(
        e for e in events if e.sequence_nr in seqs
        and e.name.startswith("autograd::engine::evaluate_function"))
    return forward, backward


def labelled_device_ms(events, label: str) -> dict:
    """Device ms of the kernels that the ops inside the ``label`` ranges
    of ``events`` launched, and of those that the autograd engine
    launched evaluating the backward nodes of the same ops."""
    forward, backward = labelled_ops(events, label)

    def ms(ops) -> float:
        return sum(k.duration for e in ops for k in e.kernels) / 1e3

    return {"forward": ms(forward), "backward": ms(backward)}


def labelled_kernel_count(events, label: str) -> int:
    """How many kernels `labelled_device_ms` sums for ``label``."""
    forward, backward = labelled_ops(events, label)
    return sum(len(e.kernels) for e in forward + backward)


def profile_dispatch(srv, prompts, max_new: int, card: str) -> dict:
    """One decode dispatch (``decode_steps`` model steps or speculative
    rounds, every slot live) under ``torch.profiler``: its wall time (and
    the next dispatch's, untraced), the host's launch calls, the device's kernel time and busy share, the
    kernels that take the most of it, and on a speculative pool the
    tokens a live row committed a round in it. Prints "not measured" for
    the device numbers where the profiler records no kernel; returns the
    printed record. K3's launch count on that dispatch (on a replay, the
    launches its capture recorded, which the server adds on each replay)
    must equal the K3 kernels the profiler saw run, or the run fails."""
    import torch

    from idunno_tpu_torch.ops.paged_attention import paged_attention_kernel

    for p in prompts:
        srv.submit(p, max_new=max_new)
    srv.step()                             # admissions + one dispatch
    cur0 = srv._cursors.cpu().clone()
    host = {}
    replays0 = srv.graph_stats()["replayed"]
    k3_0 = paged_attention_kernel.launches
    wall_ms, by_name, n = device_profile(srv.step, host)
    k3_counted = paged_attention_kernel.launches - k3_0
    k3_traced = sum(c for name, c in host["kernel_counts"].items()
                    if "paged_fwd" in name)
    committed = int((srv._cursors.cpu() - cur0).sum())
    replayed = srv.graph_stats()["replayed"] - replays0
    # the next dispatch untraced: what the profiler's own cost hides
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.step()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    srv.run_until_drained()
    busy_ms = sum(by_name.values())
    steps = srv.decode_steps
    spec = srv.stats()["config"]["speculative_draft_len"]
    rec = dict(
        card=card, quantize=srv.stats()["config"]["quantize"],
        speculative_draft_len=spec, replayed=bool(replayed),
        live_rows=len(prompts), model_steps=steps, wall_ms=wall_ms,
        wall_ms_per_model_step=wall_ms / steps,
        untraced_wall_ms=untraced_ms,
        untraced_wall_ms_per_model_step=untraced_ms / steps,
        host_launch_calls=host["launch_calls"],
        host_launch_calls_per_model_step=host["launch_calls"] / steps,
        kernel_launches_per_model_step=n / steps,
        device_busy_ms=busy_ms if n else "not measured",
        device_busy_share=busy_ms / wall_ms if n else "not measured",
        k3_launches_counted=k3_counted, k3_kernels_traced=k3_traced,
        last_kernel_end_before_sync_us=host[
            "last_kernel_end_before_sync_us"],
        tokens_committed=committed,
        tokens_per_row_per_step=committed / (len(prompts) * steps),
        top_kernels_ms=dict(by_name.most_common(8)))
    say("lm_decode_profile", **rec)
    if k3_traced != k3_counted or k3_counted <= 0:
        raise AssertionError(f"K3: {k3_counted} launches counted in the "
                             f"dispatch (replayed: {bool(replayed)}), "
                             f"{k3_traced} traced by the profiler")
    return rec


def serve_streams(model, prompts, max_new: int, **kw) -> tuple:
    """Greedy streams of ``prompts`` from one DecodeServer on the card
    (submitted at once, drained), its radix hits and its graph stats."""
    from idunno_tpu_torch.engine.serve_lm import DecodeServer

    srv = DecodeServer(model, device="cuda", **kw)
    ids = [srv.submit(p, max_new=max_new) for p in prompts]
    done = {c.id: c.tokens for c in srv.run_until_drained()}
    hits = (srv.prefix_cache_stats()["hits"] if kw.get("kv_block_size")
            else None)
    return [done[i] for i in ids], hits, srv.graph_stats()


def hold_equal(phase: str, streams: dict, **fields) -> None:
    """Every pool's greedy streams equal the first's token for token, or
    the run fails; prints the count of differing tokens per pool."""
    first, ref = next(iter(streams.items()))
    differ = {name: sum(a != b for sa, sb in zip(got, ref)
                        for a, b in zip(sa, sb))
              for name, got in streams.items()}
    say(phase, tokens_per_stream=len(ref[0]), requests=len(ref),
        tokens_differing=differ, against=first, **fields)
    bad = [name for name, got in streams.items() if got != ref]
    if bad:
        raise AssertionError(f"{phase}: pools {bad} differ from {first} in "
                             f"{differ} tokens")


def phase_lm_exactness(cfg: dict, quantize: str = "none") -> None:
    """Full width, depth 2, f32, with the dense or the int8 weights, the
    shared-prefix workload: on paged pools, K3 replayed (``decode_graph=
    "graph"``), K3 eager and the plain paged attention eager; on a
    contiguous pool, replayed and eager. Greedy streams equal token for
    token within each, radix hits > 0, and the graph pools replayed."""
    import torch

    from idunno_tpu_torch.utils.lm_bench import (prefix_bench_workload,
                                                 serving_max_new)

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_lm(cfg, "f32", depth=2, seed=1)
    prompts, _, buckets = prefix_bench_workload(cfg, LM_BLOCK)
    max_new = serving_max_new(cfg)
    paged, hits, graphs = {}, {}, {}
    for kernel, mode in (("kernel", "graph"), ("kernel", "eager"),
                         ("plain", "eager")):
        name = f"{kernel}/{mode}"
        paged[name], hits[name], graphs[name] = serve_streams(
            model, prompts, max_new, paged_kernel=kernel, decode_graph=mode,
            quantize=quantize, **lm_pool_kw(cfg, buckets))
    contiguous = {}
    kw = {k: v for k, v in lm_pool_kw(cfg, buckets).items()
          if not k.startswith("kv_")}
    for mode in ("graph", "eager"):
        contiguous[mode], _, graphs[f"contiguous/{mode}"] = serve_streams(
            model, prompts, max_new, decode_graph=mode, quantize=quantize,
            **kw)
    replayed = {k: g["replayed"] for k, g in graphs.items()}
    hold_equal("lm_exactness", paged, depth=2, dtype="float32",
               quantize=quantize, pool="paged", radix_hits=hits,
               replayed=replayed)
    hold_equal("lm_exactness", contiguous, depth=2, dtype="float32",
               quantize=quantize, pool="contiguous")
    if min(hits.values()) <= 0 or min(
            n for k, n in replayed.items() if "graph" in k) <= 0:
        raise AssertionError(f"radix hits {hits}, replays {replayed}")
    del model


def build_draft(cfg: dict, dtype, seed: int, zero: bool = False):
    """The JAX LM bench's draft (``LM_DRAFT``) at the target's vocab on the
    card, seeded (or zeroed, for the mechanism-ceiling point)."""
    return build_lm(dict(cfg, dim=LM_DRAFT["dim"], heads=LM_DRAFT["heads"]),
                    dtype, depth=LM_DRAFT["depth"], seed=seed, zero=zero)


def phase_spec_exactness(cfg: dict) -> None:
    """(a) f32, depth-2 target, the shared-prefix workload on paged pools
    (K3): speculative pools (the bench's draft, replayed and eager; the
    target as its own draft, replayed) give the greedy streams of the
    plain replayed pool."""
    import torch

    from idunno_tpu_torch.utils.lm_bench import (prefix_bench_workload,
                                                 serving_max_new)

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_lm(cfg, "f32", depth=2, seed=1)
    draft = build_draft(cfg, "f32", seed=7)
    prompts, _, buckets = prefix_bench_workload(cfg, LM_BLOCK)
    max_new = serving_max_new(cfg)
    kw = dict(paged_kernel="kernel", **lm_pool_kw(cfg, buckets))
    streams, graphs = {}, {}
    for name, extra in (
            ("plain/graph", dict(decode_graph="graph")),
            ("spec/graph", dict(decode_graph="graph", draft=(draft, None))),
            ("spec/eager", dict(decode_graph="eager", draft=(draft, None))),
            ("spec_self/graph", dict(decode_graph="graph",
                                     draft=(model, None)))):
        if "draft" in extra:
            extra["draft_len"] = LM_DRAFT_LEN
        streams[name], _, graphs[name] = serve_streams(
            model, prompts, max_new, **kw, **extra)
    hold_equal("lm_spec_exactness", streams, depth=2, dtype="float32",
               draft=LM_DRAFT, draft_len=LM_DRAFT_LEN,
               replayed={k: g["replayed"] for k, g in graphs.items()})
    del model, draft


def phase_spec_ceiling(lm, cfg: dict, card: str) -> None:
    """(c) The JAX bench's mechanism-ceiling point
    (``idunno_tpu/utils/lm_bench.py:484-520``): the full-width target and
    the bench's draft with every weight zero, so every logit ties and both
    pick token 0: acceptance 1.0. 16 rows, rounds a dispatch by the
    bench's ``spec_rounds``; each row's budget after its prefill token a
    multiple of draft_len + 1. Committed tokens a round are measured: the
    cursors and budgets are read after every timed dispatch, and each
    row's cursor advance over a dispatch that it spent live from its
    first round to its last (budget >= rounds · (draft_len + 1) before
    it) is divided by the rounds in it; every such advance must be
    rounds · (draft_len + 1), or the run fails. Tokens/s beside a plain
    pool on the same zeroed target committing as many tokens a
    dispatch."""
    import copy

    import numpy as np
    import torch

    from idunno_tpu_torch.engine.serve_lm import DecodeServer

    target = copy.deepcopy(lm)
    for prm in target.parameters():
        prm.zero_()
    draft = build_draft(cfg, "bf16", seed=0, zero=True)
    chunk = LM_DRAFT_LEN + 1
    bench = dict(cfg, max_new=448, draft_len=LM_DRAFT_LEN)
    spec_max_new = min(bench["max_new"],
                       cfg["max_len"] - cfg["prompt_len"] - chunk)
    rounds = max(1, min(cfg["decode_steps"] // chunk,
                        spec_max_new // (3 * chunk)))
    while rounds > 1 and rounds * chunk >= spec_max_new - 1:
        rounds -= 1
    max_new = 1 + (spec_max_new - 1) // chunk * chunk
    prompt = list(range(1, cfg["prompt_len"] + 1))
    out = {}
    for name, extra in (("speculative", dict(draft=(draft, None),
                                             draft_len=LM_DRAFT_LEN,
                                             decode_steps=rounds)),
                        ("plain", dict(decode_steps=rounds * chunk))):
        srv = DecodeServer(target, slots=cfg["slots"],
                           prompt_len=cfg["prompt_len"],
                           max_len=cfg["max_len"], device="cuda", **extra)
        srv.warmup()
        for _ in range(cfg["slots"]):
            srv.submit(prompt, max_new=max_new)
        srv.step()               # admission (prefills) + first dispatch
        # (cursors, budgets) after each dispatch, copied on the card's
        # stream: no host read inside the timed loop
        snaps = [(srv._cursors.clone(), srv._remaining.clone())]
        disp0 = srv.stats()["dispatches"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while True:
            left = srv.step()
            snaps.append((srv._cursors.clone(), srv._remaining.clone()))
            if left == 0:
                break
        dt = time.perf_counter() - t0
        srv.run_until_drained()
        cur = np.stack([c.cpu().numpy() for c, _ in snaps])
        rem = np.stack([r.cpu().numpy() for _, r in snaps])
        gen = int((cur[-1] - cur[0]).sum())
        out[name] = {"tokens_per_s": gen / dt, "tokens": gen,
                     "timed_dispatches": srv.stats()["dispatches"] - disp0,
                     "graph": srv.graph_stats()}
        if name == "speculative":
            advance = cur[1:] - cur[:-1]          # [dispatches, rows]
            full = rem[:-1] >= rounds * chunk     # live every round
            measured = advance[full] / rounds
            out[name]["full_dispatch_rows"] = int(full.sum())
            out[name]["rounds_measured"] = int(full.sum()) * rounds
            out[name]["committed_per_round"] = (
                float(measured.mean()) if measured.size else 0.0)
            out[name]["committed_per_round_min"] = (
                float(measured.min()) if measured.size else 0.0)
        del srv
    say("lm_spec_ceiling", card=card, draft=LM_DRAFT, draft_len=LM_DRAFT_LEN,
        rounds_per_dispatch=rounds, max_new=max_new, rows=cfg["slots"],
        speedup_vs_plain=(out["speculative"]["tokens_per_s"]
                          / out["plain"]["tokens_per_s"]), **out)
    spec = out["speculative"]
    if (spec["full_dispatch_rows"] <= 0
            or spec["committed_per_round_min"] != chunk
            or spec["committed_per_round"] != chunk):
        raise AssertionError(f"mechanism ceiling committed "
                             f"{spec['committed_per_round']} tokens a round "
                             f"(least {spec['committed_per_round_min']}) "
                             f"over {spec['full_dispatch_rows']} row "
                             f"dispatches, want {chunk}")
    if min(out[k]["graph"]["replayed"] for k in out) <= 0:
        raise AssertionError("the ceiling's dispatches were not replayed")
    del target, draft


def phase_beam(lm, cfg: dict, card: str) -> None:
    """Beam search on the card: width 1 equals greedy ``generate`` (f32,
    depth 2, full width), then the full-width bf16 model's time for
    ``BEAM`` (batch 4, width 4, 32 new tokens) after 64-token prompts."""
    import torch

    from idunno_tpu_torch.engine.generate import beam_search, generate
    from idunno_tpu_torch.utils.lm_bench import prefix_bench_workload

    torch.backends.cuda.matmul.allow_tf32 = False
    prompts, _, _ = prefix_bench_workload(cfg, LM_BLOCK)
    b, plen = BEAM["batch"], cfg["prompt_len"]
    p = torch.tensor(prompts[:b], device="cuda")
    small = build_lm(cfg, "f32", depth=2, seed=1)
    seq1, _ = beam_search(small, p, plen, BEAM["max_new"], beam_width=1)
    greedy = generate(small, p, plen, BEAM["max_new"])
    if not torch.equal(seq1, greedy):
        raise AssertionError("width-1 beam search is not greedy generate")
    del small
    beam_search(lm, p, plen, 2, beam_width=BEAM["width"])       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq, score = beam_search(lm, p, plen, BEAM["max_new"],
                             beam_width=BEAM["width"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if (seq.shape != (b, plen + BEAM["max_new"])
            or not bool(torch.isfinite(score).all())
            or not bool(((seq >= 0) & (seq < cfg["vocab"])).all())):
        raise AssertionError(f"beam search output bad: {tuple(seq.shape)}")
    say("lm_beam", card=card, width1_equals_greedy=True, dtype="bfloat16",
        depth=lm.depth, **BEAM, prompt_len=plen, wall_s=wall,
        ms_per_position=wall * 1e3 / BEAM["max_new"],
        best_scores=[float(x) for x in score])


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


@contextlib.contextmanager
def pinned_routing(chosen: list):
    """Inside the block every routed FFN takes the experts in ``chosen``:
    an empty list records the top-k picks of the forwards run inside, in
    order; a filled one forces them on the same forwards, gating with the
    router's probabilities at the forced experts."""
    from idunno_tpu_torch.models import moe

    real, record, forced = moe.top_k, not chosen, iter(list(chosen))

    def top_k(probs, k):
        if record:
            values, idx = real(probs, k)
            chosen.append(idx)
            return values, idx
        idx = next(forced)
        return probs.gather(-1, idx), idx

    moe.top_k = top_k
    try:
        yield
    finally:
        moe.top_k = real


def grad_agreement(model, tokens, pin_routing: bool = False) -> dict:
    """Every parameter's gradient of one batch's loss (cross-entropy plus
    0.01 × the routed blocks' balance loss, as the train step weighs it)
    through flash (K2, K4, K5) and through ``full`` attention, before any
    update: the smallest cosine and the largest relative difference in
    norm. ``pin_routing``: the ``full`` pass routes every token as the
    flash pass did, so that a near-tie that the two attentions' roundings
    break apart cannot move the comparison."""
    import torch

    from idunno_tpu_torch.engine.train_lm import next_token_loss
    from idunno_tpu_torch.models.moe import moe_aux_loss
    from idunno_tpu_torch.models.transformer import make_attn_fn

    grads, chosen = {}, []
    for kind in ("flash", "full"):
        model.set_attn_fn(make_attn_fn(kind))
        model.zero_grad(set_to_none=True)
        with (pinned_routing(chosen) if pin_routing
              else contextlib.nullcontext()):
            ce, _ = next_token_loss(model(tokens), tokens)
            loss = ce + 0.01 * moe_aux_loss(model)
        loss.backward()
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


# -- the routed FFN (switch MoE) on the card ------------------------------


def build_moe_lm(cfg: dict, depth: int, seed: int, *, attn: str = "full",
                 remat: bool = False, compute_dtype=None):
    """The routed LM (``MOE``: the JAX bench's widths with a switch FFN of
    8 experts on every other block) on the card, f32 parameters seeded
    with flax's initialisers."""
    import torch

    from idunno_tpu_torch.models.init import init_like_flax
    from idunno_tpu_torch.models.moe import MoETransformerLM
    from idunno_tpu_torch.models.transformer import make_attn_fn

    with torch.device("cuda"):
        model = MoETransformerLM(
            vocab=cfg["vocab"], dim=cfg["dim"], depth=depth,
            num_heads=cfg["heads"], attn_fn=make_attn_fn(attn), remat=remat,
            dtype=torch.float32, compute_dtype=compute_dtype, **MOE)
    init_like_flax(model, torch.Generator(device="cuda").manual_seed(seed))
    return model


def routed_blocks(model) -> int:
    return sum(blk.ffn is not None for blk in model.blocks)


def active_params(model) -> int:
    """Parameters a token runs through: every expert FFN counts k of its
    E experts (the router and the rest count in full)."""
    n = sum(p.numel() for p in model.parameters())
    for blk in model.blocks:
        if blk.ffn is not None:
            per_expert = sum(p[0].numel() for p in (blk.ffn.w1, blk.ffn.b1,
                                                    blk.ffn.w2, blk.ffn.b2))
            n -= (blk.ffn.n_experts - blk.ffn.k) * per_expert
    return n


def router_picks(model) -> tuple[list, list]:
    """Forward hooks on every routed block's router recording each token's
    top-1 expert; returns (the picks list, the hook handles)."""
    picks, hooks = [], []
    for blk in model.blocks:
        if blk.ffn is not None:
            hooks.append(blk.ffn.router.register_forward_hook(
                lambda mod, args, out: picks.append(out.argmax(-1))))
    return picks, hooks


def phase_moe_prefill(cfg: dict, card: str) -> int:
    """The routed LM's full forward at [4, 1024], bf16, through
    ``make_attn_fn("auto")`` (K2 on the card) against ``full`` attention:
    K2 launches equal depth × forwards, the logits within 2% of the
    ``full`` forward's largest, the share of routing decisions the two
    forwards take differently, tokens/s; returns K2's launches."""
    import torch

    from idunno_tpu_torch.models.transformer import make_attn_fn

    model = build_moe_lm(cfg, cfg["depth"], seed=6).to(
        torch.bfloat16).eval().requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != MOE_PARAMS:
        raise AssertionError(f"routed LM has {n_params} parameters, want "
                             f"{MOE_PARAMS}")
    b, t = cfg["prefill_batch"], cfg["prefill_seq"]
    g = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(1, cfg["vocab"], (b, t), generator=g, device="cuda")
    rates, logits, picks = {}, {}, {}
    with torch.no_grad():
        for kind in ("full", "auto"):
            model.set_attn_fn(make_attn_fn(kind))
            seen, hooks = router_picks(model)
            model(toks)                                   # warm
            for h in hooks:
                h.remove()
            picks[kind] = torch.stack(seen)
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
    ref, got = logits["full"], logits["auto"]
    if got.shape != (b, t, cfg["vocab"]) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"routed prefill logits bad: {tuple(got.shape)}")
    rel = float((got - ref).abs().max() / ref.abs().max())
    flips = float((picks["auto"] != picks["full"]).float().mean())
    say("moe_prefill", card=card, batch=b, seq=t, depth=model.depth,
        routed_blocks=routed_blocks(model), n_params=n_params,
        active_params=active_params(model), forwards=LM_FORWARDS,
        flash_tokens_per_s=rates["auto"], full_tokens_per_s=rates["full"],
        flash_launches=launches, flash_vs_full_max_rel_err=rel,
        tolerance=2e-2, routing_decisions_differing=flips)
    if launches != model.depth * LM_FORWARDS:
        raise AssertionError(f"K2 launched {launches} times in "
                             f"{LM_FORWARDS} routed forwards of depth "
                             f"{model.depth}")
    if not rel <= 2e-2:
        raise AssertionError(f"routed flash forward off the full forward by "
                             f"{rel} ({flips} of the routing decisions differ)")
    model.set_attn_fn(make_attn_fn("auto"))
    with torch.no_grad():
        wall_ms, by_name, n = device_profile(lambda: model(toks))
    busy_ms = sum(by_name.values())
    say("moe_prefill_profile", card=card, wall_ms=wall_ms,
        kernel_launches=n,
        device_busy_ms=busy_ms if n else "not measured",
        device_busy_share=busy_ms / wall_ms if n else "not measured",
        top_kernels_ms=dict(by_name.most_common(8)))
    del model
    torch.cuda.empty_cache()
    return launches


def phase_moe_train(card: str) -> dict:
    """The routed LM trained on the card through K2, K4 and K5 (f32
    parameters, bf16 compute, seq 1024 × batch 8, fused AdamW): at depth
    2, flash and ``full`` gradients agree (cosine ≥ 0.999, norms within
    2%) in f32 and in bf16 compute with the ``full`` pass routed as the
    flash pass was, and ``remat=True`` gives the same loss and gradients
    within 1e-5 of the largest (its recompute runs K2 a second time a
    block); at full width, ``MOE_TRAIN_STEPS`` steps on one batch with
    finite, falling loss and a finite balance loss, K2/K4/K5 launches of
    depth × steps, step ms, tokens/s, MFU over the active parameters, and
    the dispatch and combine einsums' share of the step's device time,
    read from the step's trace. Returns the launches of the counted steps
    and of the remat check."""
    import numpy as np
    import torch

    from idunno_tpu_torch.engine.data_lm import TokenDataset
    from idunno_tpu_torch.engine.train import adamw, flat_tx
    from idunno_tpu_torch.engine.train_lm import (create_lm_train_state,
                                                  make_lm_train_step,
                                                  next_token_loss)
    from idunno_tpu_torch.models.moe import (COMBINE_SPAN, DISPATCH_SPAN,
                                             moe_aux_loss)
    from idunno_tpu_torch.models.transformer import make_attn_fn
    from idunno_tpu_torch.utils.train_bench import (H100_BF16_FLOPS,
                                                    lm_flops_per_token,
                                                    train_bench_config)

    cfg = train_bench_config("cuda")
    b, t = cfg["batch"], cfg["seq"]
    corpus = np.random.default_rng(1).integers(0, cfg["vocab"],
                                               4 * b * (t + 1))
    block = next(TokenDataset(corpus, t, seed=0).batches(b))
    tokens = torch.from_numpy(block[:, :t]).to("cuda", torch.int64)
    lm_cfg = dict(cfg, heads=cfg["heads"])
    launches = {}

    # depth 2 (block 1 routed): flash against full, held in f32 (K2, K4 and
    # K5's f32 variants, where the two attentions agree to rounding and
    # route alike) and in the bf16 compute the step trains in. Routing is
    # a step function of the activations: in bf16 a token whose two best
    # experts are near a tie may route apart under the two attentions'
    # roundings, so there the full pass is held to the flash pass's
    # experts (the share that would route apart is printed)
    gate = {"min_cosine": 0.999, "max_norm_rel_diff": 0.02}
    for dtype in (None, torch.bfloat16):
        model = build_moe_lm(lm_cfg, 2, seed=7, attn="flash",
                             compute_dtype=dtype)
        picks = {}
        for kind in ("flash", "full"):
            model.set_attn_fn(make_attn_fn(kind))
            seen, hooks = router_picks(model)
            with torch.no_grad():
                model(tokens)
            for h in hooks:
                h.remove()
            picks[kind] = torch.stack(seen)
        agree = grad_agreement(model, tokens, pin_routing=dtype is not None)
        say("moe_train_grads", card=card, depth=2, compare="flash_vs_full",
            dtype=("bfloat16 compute, float32 parameters, routing pinned"
                   if dtype else "float32"),
            routing_decisions_differing_unpinned=float(
                (picks["flash"] != picks["full"]).float().mean()),
            **agree, tolerance=gate)
        if not (agree["min_cosine"] >= gate["min_cosine"]
                and agree["max_norm_rel_diff"] <= gate["max_norm_rel_diff"]):
            raise AssertionError(f"routed flash and full gradients disagree "
                                 f"({dtype or torch.float32}): {agree}")
        if dtype is None:
            del model
    small = model
    grads, losses = {}, {}
    for remat in (False, True):
        small.remat = remat
        small.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        zero_launches()
        ce, _ = next_token_loss(small(tokens), tokens)
        loss = ce + 0.01 * moe_aux_loss(small)
        loss.backward()
        torch.cuda.synchronize()
        counted = read_launches()
        losses[remat] = float(loss.detach())
        grads[remat] = {n: p.grad.detach().clone()
                        for n, p in small.named_parameters()}
        if remat:
            for name, n in counted.items():
                launches[name] = launches.get(name, 0) + n
            remat_launches = counted
    worst = max(float((grads[True][n] - g).abs().max()
                      / max(float(g.abs().max()), 1e-30))
                for n, g in grads[False].items())
    say("moe_train_remat", card=card, depth=2, loss=losses[False],
        remat_loss=losses[True], max_grad_diff_rel=worst, tolerance=1e-5,
        remat_launches=remat_launches)
    if losses[True] != losses[False] or not worst <= 1e-5:
        raise AssertionError(f"remat changes the step: losses {losses}, "
                             f"largest gradient difference {worst}")
    if (remat_launches["flash_attention"] != 2 * 2
            or remat_launches["flash_attention_bwd_dq"] != 2):
        raise AssertionError(f"remat launches {remat_launches}: want K2 "
                             "twice a block (forward and recompute)")
    del small, grads
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model = build_moe_lm(lm_cfg, cfg["depth"], seed=8, attn="flash",
                         compute_dtype=torch.bfloat16)
    state = create_lm_train_state(
        model, torch.Generator(device="cuda").manual_seed(8),
        flat_tx(adamw(3e-4)))
    step = make_lm_train_step(model, state.optimizer)
    float(step(state, tokens)["loss"])                    # builds, warms
    torch.cuda.synchronize()
    zero_launches()
    losses, auxes, times = [], [], []
    for _ in range(MOE_TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
        auxes.append(float(metrics["aux"]))
    counted = read_launches()
    for name, n in counted.items():
        launches[name] = launches.get(name, 0) + n
    step_s = sorted(times)[len(times) // 2]
    n_params = sum(p.numel() for p in model.parameters())
    active = active_params(model)
    tok_s = b * t / step_s
    flops_tok = lm_flops_per_token(active, cfg)
    mfu = tok_s * flops_tok / H100_BF16_FLOPS
    state_bytes = sum(p.numel() * p.element_size() * 3
                      for p in model.parameters())
    say("moe_train", card=card, batch=b, seq=t, depth=cfg["depth"],
        routed_blocks=routed_blocks(model), experts=MOE["n_experts"],
        n_params=n_params, active_params=active, steps=MOE_TRAIN_STEPS,
        losses=losses, aux=auxes, step_ms_median=step_s * 1e3,
        step_ms=[x * 1e3 for x in times], tokens_per_s=tok_s, mfu=mfu,
        mfu_formula=("tokens/s x (6 x active params + 12 x seq x dim x "
                     "depth) / 989e12 (H100 SXM bf16 dense); active params"
                     " count k=1 of the 8 experts of a routed block"),
        params_and_adam_state_bytes=state_bytes,
        peak_allocated_bytes=torch.cuda.max_memory_allocated(),
        launches=counted)
    if (not all(math.isfinite(x) for x in losses + auxes)
            or not losses[-1] < losses[0]):
        raise AssertionError(f"routed training loss not finite and falling: "
                             f"{losses}, aux {auxes}")
    for name in ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        if counted[name] != cfg["depth"] * MOE_TRAIN_STEPS:
            raise AssertionError(f"{name} launched {counted[name]} times in "
                                 f"{MOE_TRAIN_STEPS} routed steps")

    host = {}
    wall_ms, by_name, n = device_profile(lambda: step(state, tokens), host,
                                         labels=(DISPATCH_SPAN, COMBINE_SPAN))
    busy_ms = sum(by_name.values())
    flash_ms = sum(v for k, v in by_name.items()
                   if "flash_fwd" in k or "flash_bwd" in k)
    spans = host["labelled_ms"]
    einsum_ms = sum(sum(v.values()) for v in spans.values())
    del model, state, step
    say("moe_train_profile", card=card, wall_ms=wall_ms, kernel_launches=n,
        device_busy_ms=busy_ms if n else "not measured",
        device_busy_share=busy_ms / wall_ms if n else "not measured",
        flash_device_ms=flash_ms if n else "not measured",
        dispatch_combine_device_ms=spans if n else "not measured",
        dispatch_einsums_share_of_device=(einsum_ms / busy_ms if n
                                          else "not measured"),
        share_formula=("device ms of the kernels under SwitchFFN's "
                       f"{DISPATCH_SPAN!r} and {COMBINE_SPAN!r} ranges and "
                       "of their backward nodes, every routed block, / the "
                       "step's device ms"),
        top_kernels_ms=dict(by_name.most_common(10)))
    if n and not 0 < einsum_ms < busy_ms:
        raise AssertionError(f"dispatch/combine device ms {spans} outside "
                             f"the step's {busy_ms} ms")
    torch.cuda.empty_cache()
    return launches


def loop_serve(srv, prompts, max_new: int, cfg: dict) -> tuple[dict, dict]:
    """``prompts`` submitted to a warmed ``srv`` from two threads through
    an LMServingLoop, with a span trace each, every stream checked for
    its length and vocab: (served tokens/s, TTFT p50/p95 from
    ``lm.admit`` start to ``lm.prefill`` end, the K3 launches of the run
    and the like; the loop's stats)."""
    from idunno_tpu_torch.serve.lm_pool import LMServingLoop
    from idunno_tpu_torch.utils.spans import SpanStore

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
    ttft = []
    wire = spans.dump()
    for tid in traces.values():
        mine = {s["name"]: s for s in wire if s["trace_id"] == tid}
        ttft.append(mine["lm.prefill"]["t_end"] - mine["lm.admit"]["t_start"])
    ttft.sort()
    gen = sum(len(c.tokens) - c.prompt_len for c in done.values())
    return {"requests": len(done), "wall_s": wall, "tokens_generated": gen,
            "tokens_per_s": gen / wall, "ttft_p50_s": ttft[len(ttft) // 2],
            "ttft_p95_s": ttft[min(len(ttft) - 1, int(0.95 * len(ttft)))],
            "dispatches": stats["dispatches"],
            "radix_hits": stats["prefix_cache"]["hits"],
            "kv_gather_bytes_saved": stats["kv_gather_bytes_saved"],
            "paged_launches": launches}, stats


def phase_moe_serving(cfg: dict, card: str) -> None:
    """The routed LM (bf16, full width) served from a gathered KV block
    pool (``kv_block_size`` without ``paged_kernel``: the JAX package's
    MoE pools), 16 slots, the shared-prefix prompts: a replayed and an
    eager pool give equal greedy streams (all prompts submitted at once:
    a routed row's output depends on the rows beside it); the replayed
    pool then serves the prompts from two threads through an
    LMServingLoop (tokens/s, TTFT p50/p95), and so does the dense LM of
    the same widths on the same kind of pool; a routed pool with
    ``paged_kernel="auto"`` raises."""
    import torch

    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.utils.lm_bench import (prefix_bench_workload,
                                                 serving_max_new)

    model = build_moe_lm(cfg, cfg["depth"], seed=6).to(
        torch.bfloat16).eval().requires_grad_(False)
    prompts, _, buckets = prefix_bench_workload(cfg, LM_BLOCK)
    max_new = serving_max_new(cfg)
    pool = lm_pool_kw(cfg, buckets)
    try:
        DecodeServer(model, paged_kernel="auto", device="cuda", **pool)
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("a routed pool took paged_kernel='auto'")
    streams, hits, graphs = {}, {}, {}
    for mode in ("graph", "eager"):
        streams[mode], hits[mode], graphs[mode] = serve_streams(
            model, prompts, max_new, decode_graph=mode, **pool)
    hold_equal("moe_exactness", streams, depth=cfg["depth"],
               dtype="bfloat16", pool="gathered", radix_hits=hits,
               replayed={k: g["replayed"] for k, g in graphs.items()})
    if hits["graph"] <= 0 or graphs["graph"]["replayed"] <= 0:
        raise AssertionError(f"routed pool: radix hits {hits}, graphs "
                             f"{graphs}")

    served = {}
    for arm in ("routed", "dense"):
        if arm == "dense":
            model = build_lm(cfg, "bf16", cfg["depth"], seed=6)
        srv = DecodeServer(model, device="cuda", **pool)
        warm_s = srv.warmup()
        served[arm] = dict(loop_serve(srv, prompts, max_new, cfg)[0],
                           warmup_s=warm_s, graphs=srv.graph_stats())
        del srv, model
        torch.cuda.empty_cache()
    graph = served["routed"].pop("graphs")
    say("moe_serving", card=card, slots=cfg["slots"],
        pool="gathered block pool (kv_block_size 16, no paged_kernel)",
        decode_graph=graph["mode"], dispatches_replayed=graph["replayed"],
        dispatches_eager=graph["eager"], max_new=max_new,
        **served["routed"], dense_same_pool=served["dense"],
        routed_over_dense_tokens_per_s=(served["routed"]["tokens_per_s"]
                                        / served["dense"]["tokens_per_s"]),
        paged_kernel_refusal=refusal)
    if graph["replayed"] <= 0:
        raise AssertionError(f"no routed dispatch was replayed: {graph}")


def phase_failed_capture(card: str) -> None:
    """After a provoked failed CUDA-graph capture (a dispatch that reads
    the card back, as ``tests/test_torch_kernels.py::
    test_failed_capture_raises`` provokes it), the same pool serves a
    sampled request, equal to an eager pool's stream from the same seed,
    and a random draw on the card succeeds in the same process."""
    import torch

    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.models.init import init_like_flax
    from idunno_tpu_torch.models.transformer import TransformerLM

    with torch.device("cuda"):
        model = TransformerLM(vocab=257, dim=64, depth=2, num_heads=2)
    init_like_flax(model, torch.Generator(device="cuda").manual_seed(1))
    model.eval().requires_grad_(False)
    srv = DecodeServer(model, slots=2, prompt_len=8, max_len=48,
                       decode_graph="graph", device="cuda")
    dispatch = srv._dispatch

    def syncing(sampled):
        dispatch(sampled)
        return float(srv._cursors.sum())          # a host read

    srv._dispatch = syncing
    srv.submit([1, 2, 3], max_new=8)
    try:
        srv.run_until_drained()
    except RuntimeError as e:
        failure = f"{type(e).__name__}: {str(e)[:200]}"
    else:
        raise AssertionError("a syncing dispatch was captured")
    rid = srv.submit([4, 5, 6, 7], max_new=24, temperature=0.9, seed=11)
    got = {c.id: c.tokens for c in srv.run_until_drained()}[rid]
    ref = DecodeServer(model, slots=2, prompt_len=8, max_len=48,
                       decode_graph="eager", device="cuda")
    ref_id = ref.submit([4, 5, 6, 7], max_new=24, temperature=0.9, seed=11)
    want = {c.id: c.tokens for c in ref.run_until_drained()}[ref_id]
    draw = torch.randn(1024, device="cuda")
    say("failed_capture", card=card, failure=failure,
        sampled_tokens=len(got) - 4, sampled_equals_eager_pool=got == want,
        cuda_randn_finite=bool(torch.isfinite(draw).all()),
        replayed=srv.graph_stats()["replayed"])
    if got != want or not bool(torch.isfinite(draw).all()):
        raise AssertionError("after a failed capture the pool's sampled "
                             f"stream {got} differs from {want}")


def phase_cnn_int8_s2d(dense, card: str) -> int:
    """ResNet-18 with int8 weights and with the space-to-depth stem on the
    weights of ``dense`` (the ``kernel`` engine): int8 logits against the
    same engine on its dequantized weights, s2d logits against the 7x7
    engine's, each path's images/s, and the int8 engine's stored bytes
    against dense; returns K1's launches in the int8 and s2d queries."""
    import torch

    from idunno_tpu_torch.config import EngineConfig
    from idunno_tpu_torch.engine import data as data_lib
    from idunno_tpu_torch.engine.inference import InferenceEngine
    from idunno_tpu_torch.ops.quantize import dequantize_tree, quantized_bytes

    name = "resnet"
    cfg = dict(batch_size=BATCH, image_size=CROP, resize_size=SIDE,
               preprocess="kernel")
    weights = dense._models[name].state_dict()
    engines = {"dense": dense,
               "int8": InferenceEngine(EngineConfig(quantize="int8", **cfg)),
               "s2d": InferenceEngine(EngineConfig(stem_s2d=True, **cfg))}
    for mode in ("int8", "s2d"):
        engines[mode].load(name, state_dict=weights)
    deq = InferenceEngine(EngineConfig(**cfg))
    deq.load(name, state_dict=dequantize_tree(engines["int8"]._models[name]))
    _, images = data_lib.load_range(None, 0, BATCH - 1)
    batch = torch.from_numpy(images).cuda()
    # both sides hold the same bf16 weights (int8 dequantized and cast);
    # they differ in the convolutions' algorithms and memory formats (the
    # dequantized weight is contiguous, the dense one channels_last). The
    # s2d stem sums the same taps in another order: its bf16 output
    # rounds differently and the difference runs through the network
    tol = {"int8_vs_dequantized": 1e-2, "s2d_vs_7x7": 2e-2}
    pairs = {"int8_vs_dequantized": (engines["int8"], deq),
             "s2d_vs_7x7": (engines["s2d"], dense)}
    for label, (a, b) in pairs.items():
        out, ref = a.logits(name, batch), b.logits(name, batch)
        if out.shape != (BATCH, 1000) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label}: bad logits {tuple(out.shape)}")
        rel = float((out - ref).abs().max() / ref.abs().max())
        top1 = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
        say("cnn_int8_s2d", model=name, compare=label, max_rel_err=rel,
            tolerance=tol[label], top1_agreement=top1)
        if not rel <= tol[label]:
            raise AssertionError(f"{label}: logits off by {rel}")
    stored, dense_f32 = quantized_bytes(engines["int8"]._models[name])
    bf16 = weight_bytes(dense._models[name])
    del deq
    _, block = data_lib.load_range(None, 0, N_QUERY - 1)
    staged, n = dense.stage(block)
    zero_launches()
    for mode in ("int8", "s2d"):
        res = engines[mode].infer(name, 0, N_QUERY - 1)
        if len(res.records) != N_QUERY:
            raise AssertionError(f"{mode}: {len(res.records)} records")
    launches = read_launches()["preprocess"]
    if launches < 2 * N_QUERY // BATCH:
        raise AssertionError(f"K1 launched {launches} times in the int8 and "
                             "s2d queries")
    rates = staged_rates(engines, name, staged, n,
                         ["dense", "int8", "s2d", "s2d", "int8", "dense"] * 2)
    for mode, r in rates.items():
        say("cnn_int8_s2d", model=name, path=mode, card=card,
            staged_images_per_s_median=(r[1] + r[2]) / 2,
            staged_images_per_s_min=r[0], staged_images_per_s_max=r[-1])
    say("cnn_int8_s2d", model=name, stored_bytes=stored,
        dense_f32_bytes=dense_f32, dense_bf16_param_bytes=bf16,
        preprocess_launches=launches)
    return launches


def vit_logits(eng, staged, attn_fn=None):
    """f32 logits of every staged batch through ``eng``'s ViT, its blocks
    attending through ``attn_fn`` (default: as built)."""
    import torch

    blocks = eng._models["vit"].blocks
    built = blocks[0].attn.attn_fn
    for blk in blocks:
        blk.attn.attn_fn = attn_fn or built
    try:
        return torch.cat([eng.logits("vit", b).float() for b in staged])
    finally:
        for blk in blocks:
            blk.attn.attn_fn = built


def agreement(a, b) -> dict:
    """Top-1 agreement, max |difference| and max |difference| over
    max|b| of two logit blocks."""
    diff = float((a - b).abs().max())
    return {"top1": float((a.argmax(-1) == b.argmax(-1)).float().mean()),
            "max_abs_dlogit": diff, "max_rel_err": diff / float(b.abs().max())}


def phase_vit_serving(card: str) -> dict:
    """ViT-S/16 at full width (dim 384, depth 12, 6 heads, 224² crops of
    256², engine batch 256, bf16, seeded weights) served by
    ``InferenceEngine`` through K1 and K2: a query of ``N_QUERY`` images,
    K2 launches equal to 12 x the forward batches; logits against
    ``full`` attention on the same weights, in bf16 and in f32, and
    against an f32 CPU reference; returns the K1 and K2 launches of the
    query.

    The top-1 gate runs in f32 (K2's f32 variant against ``full``): with
    seeded random weights 5% of the images have a top-2 logit margin
    below 0.011 while either bf16 forward moves logits by up to 0.05, so
    in bf16 flash and ``full`` each keep the f32 top-1 on only about 96%
    of the images (PERF.md §6). The bf16 paths are held to the 2%
    relative tolerance of the LM prefill's flash-vs-full check."""
    import numpy as np
    import torch

    from idunno_tpu_torch.config import EngineConfig
    from idunno_tpu_torch.engine import data as data_lib
    from idunno_tpu_torch.engine.inference import InferenceEngine
    from idunno_tpu_torch.ops.attention import full_attention

    name = "vit"
    cfg = dict(batch_size=BATCH, image_size=CROP, resize_size=SIDE)
    eng = InferenceEngine(EngineConfig(preprocess="kernel", **cfg), seed=0)
    warm_s = eng.warmup(name)
    model = eng._models[name]
    depth = len(model.blocks)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.time()
    res = eng.infer(name, 0, N_QUERY - 1)
    wall = time.time() - t0
    launches = read_launches()
    batches = -(-N_QUERY // BATCH)
    if len(res.records) != N_QUERY or {r[0] for r in res.records} != {
            f"test_{i}.JPEG" for i in range(N_QUERY)}:
        raise AssertionError(f"vit: {len(res.records)} records of {N_QUERY}")
    if not all(math.isfinite(p) and 0.0 <= p <= 1.0 for *_, p in res.records):
        raise AssertionError("vit: malformed record")
    if launches["flash_attention"] != depth * batches:
        raise AssertionError(f"K2 launched {launches['flash_attention']} "
                             f"times in {batches} forwards of depth {depth}")
    if launches["preprocess"] < batches:
        raise AssertionError(f"K1 launched {launches['preprocess']} times")
    _, block = data_lib.load_range(None, 0, N_QUERY - 1)
    staged, n = eng.stage(block)
    rates = {}
    for kind, fn in (("flash", None), ("full", full_attention)):
        vit_logits(eng, staged[:1], fn)                    # warm
        torch.cuda.synchronize()
        t1 = time.time()
        vit_logits(eng, staged, fn)
        torch.cuda.synchronize()
        rates[kind] = n / (time.time() - t1)
    flash = vit_logits(eng, staged)
    full = vit_logits(eng, staged, full_attention)
    if not bool(torch.isfinite(flash).all()) or flash.shape != (n, 1000):
        raise AssertionError(f"vit: bad logits {tuple(flash.shape)}")
    # the same weights in f32 on the card (no TF32): K2's f32 variant
    # against full attention, and the reference for both bf16 paths
    backends = torch.backends
    tf32 = backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32
    backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
    f32 = InferenceEngine(EngineConfig(preprocess="plain",
                                       compute_dtype="float32", **cfg))
    f32.load(name, state_dict={k: v.float()
                               for k, v in model.state_dict().items()})
    flash32 = vit_logits(f32, staged)
    full32 = vit_logits(f32, staged, full_attention)
    backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32 = tf32
    del f32
    top2 = full32.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    cmp = {"bf16_flash_vs_bf16_full": agreement(flash, full),
           "bf16_flash_vs_f32_full": agreement(flash, full32),
           "bf16_full_vs_f32_full": agreement(full, full32),
           "f32_flash_vs_f32_full": agreement(flash32, full32)}
    # the card's bf16 forward against an f32 CPU reference on 8 images
    cpu = InferenceEngine(EngineConfig(
        batch_size=8, image_size=CROP, resize_size=SIDE,
        compute_dtype="float32", preprocess="plain"), device="cpu")
    cpu.load(name, state_dict={k: v.float().cpu()
                               for k, v in model.state_dict().items()})
    ref = cpu.logits(name, torch.from_numpy(np.ascontiguousarray(block[:8])))
    cpu_rel = float((flash[:8].cpu() - ref).abs().max() / ref.abs().max())
    say("vit_serving", card=card, images=N_QUERY, dim=model.dim,
        depth=depth, tokens=(CROP // model.patch) ** 2 + 1, warmup_s=warm_s,
        wall_s=wall, infer_images_per_s=N_QUERY / wall,
        staged_images_per_s_flash=rates["flash"],
        staged_images_per_s_full_attention=rates["full"],
        flash_launches=launches["flash_attention"],
        preprocess_launches=launches["preprocess"], forward_batches=batches,
        **cmp, f32_top2_margin_quantiles={
            q: float(margin.quantile(q)) for q in (0.01, 0.05, 0.1, 0.5)},
        card_vs_cpu_f32_max_rel_err=cpu_rel,
        tolerance={"f32_flash_vs_f32_full_top1": 0.99,
                   "bf16_max_rel_err": 2e-2, "card_vs_cpu_f32": 5e-2},
        weights=res.weights)
    if cmp["f32_flash_vs_f32_full"]["top1"] < 0.99:
        raise AssertionError(f"vit: f32 flash and full top-1 agree on "
                             f"{cmp['f32_flash_vs_f32_full']['top1']}")
    for key in ("bf16_flash_vs_bf16_full", "bf16_flash_vs_f32_full"):
        if not cmp[key]["max_rel_err"] <= 2e-2:
            raise AssertionError(f"vit: {key} off by {cmp[key]}")
    if not cpu_rel <= 5e-2:
        raise AssertionError(f"vit: card vs CPU reference off by {cpu_rel}")
    wall_ms, by_name, k = device_profile(lambda: eng.logits(name, staged[0]))
    busy_ms = sum(by_name.values())
    flash_ms = sum(v for key, v in by_name.items() if "flash_fwd" in key)
    say("vit_profile", card=card, batch=BATCH, wall_ms=wall_ms,
        kernel_launches=k,
        device_busy_ms=busy_ms if k else "not measured",
        device_busy_share=busy_ms / wall_ms if k else "not measured",
        flash_device_ms=flash_ms if k else "not measured",
        flash_share_of_device=flash_ms / busy_ms if k else "not measured",
        top_kernels_ms=dict(by_name.most_common(8)))
    return {"preprocess": launches["preprocess"],
            "flash_attention": launches["flash_attention"]}


def phase_default_pool(card: str) -> int:
    """The JAX package's default-size ``TransformerLM`` (dim 128, 4 heads:
    head_dim 32; vocab 1024, depth 2, f32) in a paged pool on the card
    through K3: a ``kernel`` and a ``plain`` pool serve the shared-prefix
    workload; equal greedy streams, radix hits, K3 launches > 0; returns
    them."""
    import torch

    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.models.init import init_like_flax
    from idunno_tpu_torch.models.transformer import TransformerLM
    from idunno_tpu_torch.utils.lm_bench import (prefix_bench_workload,
                                                 serving_max_new)

    cfg = {"vocab": 1024, "slots": 4, "prompt_len": 64, "max_len": 128,
           "decode_steps": LM_DECODE_STEPS}
    with torch.device("cuda"):
        model = TransformerLM(vocab=cfg["vocab"], dim=128, depth=2,
                              num_heads=4)
    init_like_flax(model, torch.Generator(device="cuda").manual_seed(2))
    model.eval().requires_grad_(False)
    prompts, _, buckets = prefix_bench_workload(cfg, LM_BLOCK)
    max_new = serving_max_new(cfg)
    streams, hits = {}, {}
    for kernel in ("plain", "kernel"):
        srv = DecodeServer(model, paged_kernel=kernel, device="cuda",
                           **lm_pool_kw(cfg, buckets))
        torch.cuda.synchronize()
        zero_launches()
        ids = [srv.submit(p, max_new=max_new) for p in prompts]
        done = {c.id: c.tokens for c in srv.run_until_drained()}
        launches = read_launches()["paged_attention"]
        streams[kernel] = [done[i] for i in ids]
        hits[kernel] = srv.prefix_cache_stats()["hits"]
    differ = sum(a != b for sa, sb in zip(streams["kernel"], streams["plain"])
                 for a, b in zip(sa, sb))
    say("lm_default_pool", card=card, dim=128, heads=4, head_dim=32,
        depth=2, dtype="float32", requests=len(prompts),
        tokens_per_stream=len(streams["kernel"][0]), radix_hits=hits,
        paged_launches=launches, tokens_differing=differ)
    if streams["kernel"] != streams["plain"] or hits["kernel"] <= 0:
        raise AssertionError(f"default-size kernel and plain pools differ in "
                             f"{differ} tokens (hits {hits})")
    if launches <= 0:
        raise AssertionError("K3 never launched in the default-size pool")
    return launches


def tp_streams(model, prompts, max_new: int, mesh=None, sampled=None,
               **kw) -> dict:
    """One pool on the card (``mesh``: tensor-parallel over it) serving
    ``prompts`` greedily, then ``sampled`` (a prompt and its sampling
    keys) alone: the greedy and sampled streams, radix hits, graph stats,
    the greedy decode tokens/s of a second, warm pass of the prompts, and
    K3's launches over all of it (zeroed just before the pool is built,
    read after the warm pass)."""
    import torch

    from idunno_tpu_torch.engine.serve_lm import DecodeServer

    torch.cuda.synchronize()
    zero_launches()
    srv = DecodeServer(model, device="cuda", mesh=mesh, **kw)
    ids = [srv.submit(p, max_new=max_new) for p in prompts]
    done = {c.id: c.tokens for c in srv.run_until_drained()}
    out = {"greedy": [done[i] for i in ids]}
    if sampled is not None:
        prompt, keys = sampled
        rid = srv.submit(prompt, max_new=max_new, **keys)
        out["sampled"] = {c.id: c.tokens
                          for c in srv.run_until_drained()}[rid]
    out["hits"] = srv.prefix_cache_stats()["hits"]
    out["graph"] = srv.graph_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        srv.submit(p, max_new=max_new)
    srv.run_until_drained()
    torch.cuda.synchronize()
    out["tokens_per_s"] = (len(prompts) * (max_new - 1)
                           / (time.perf_counter() - t0))
    out["launches"] = read_launches()["paged_attention"]
    del srv
    return out


def teacher_forced_logits(dec, tokens):
    """f32 logits [B, T, vocab] of ``tokens`` [B, T] in one chunked
    decode step (scalar cursor 0) of ``dec`` (a model or its
    tensor-parallel decoder), the vocab parts joined."""
    import torch

    from idunno_tpu_torch.engine.generate import init_cache
    from idunno_tpu_torch.models.transformer import decode_apply

    with torch.no_grad():
        cache = init_cache(dec, tokens.shape[0], tokens.shape[1])
        out = decode_apply(dec, cache, tokens, 0)
    return torch.cat(out.parts, dim=-1) if hasattr(out, "parts") else out


def phase_tp_decode(cfg: dict, card: str) -> int:
    """(``tp_decode``) Tensor-parallel decode on a virtual mesh of the
    card: the full-width LM in a paged pool (K3 per model shard, each on
    16 / n_model KV heads; head-sharded block stores; vocab-sharded tail),
    at n_model 2 and 4 against n_model 1.

    f32 compute, K3 on f32 pages (TF32 off): the greedy streams of
    ``TP["requests"]`` shared-prefix requests (radix hits among them) and
    one seeded sampled stream equal n_model 1's token for token; the
    pool's K3 launches equal n_model x the n_model 1 pool's. bf16 compute:
    n_model 1's greedy streams teacher-forced through the tensor-parallel
    decoder give logits within ``TP["bf16_rel_tol"]`` of n_model 1's,
    relative to each row's largest |logit| (printed beside the same
    difference between n_model 1's bf16 and f32 logits), and the share of
    greedy tokens a bf16 TP pool serves differently (printed, not gated).
    Decode tokens/s of each pool (a warm second pass), with the card's
    name and power limit: informational. Returns the phase's K3
    launches."""
    import torch

    from idunno_tpu_torch.models.transformer import ShardedLM
    from idunno_tpu_torch.parallel.mesh import virtual_mesh
    from idunno_tpu_torch.utils.lm_bench import prefix_bench_workload

    torch.backends.cuda.matmul.allow_tf32 = False
    prompts, _, buckets = prefix_bench_workload(cfg, LM_BLOCK)
    greedy = prompts[:TP["requests"]]
    sampled = (prompts[TP["requests"]],
               {"temperature": 0.8, "top_p": 0.9, "seed": 21})
    kw = dict(lm_pool_kw(cfg, buckets), paged_kernel="kernel")
    max_new = TP["max_new"]
    meshes = {1: None, **{n: virtual_mesh(1, n, "cuda:0")
                          for n in TP["n_models"]}}
    total = 0
    model = build_lm(cfg, "f32", depth=cfg["depth"], seed=TP["seed"])
    runs = {}
    for n, mesh in meshes.items():
        runs[n] = tp_streams(model, greedy, max_new, mesh=mesh,
                             sampled=sampled, **kw)
        total += runs[n]["launches"]
        torch.cuda.empty_cache()
    base = runs[1]
    for n in TP["n_models"]:
        run = runs[n]
        differ = sum(a != b for sa, sb in zip(run["greedy"], base["greedy"])
                     for a, b in zip(sa, sb))
        say("tp_decode", card=card, dtype="float32", n_model=n,
            mesh="virtual 1 x %d over cuda:0" % n, depth=cfg["depth"],
            dim=cfg["dim"], kv_heads_per_shard=cfg["heads"] // n,
            requests=len(greedy), max_new=max_new,
            greedy_tokens_differing=differ,
            sampled_equal=run["sampled"] == base["sampled"],
            radix_hits=run["hits"], k3_launches=run["launches"],
            k3_launches_n_model_1=base["launches"],
            replayed=run["graph"]["replayed"],
            decode_tokens_per_s=run["tokens_per_s"],
            decode_tokens_per_s_n_model_1=base["tokens_per_s"],
            tokens_per_s_note="informational, a virtual mesh on one card")
        if run["greedy"] != base["greedy"] or \
                run["sampled"] != base["sampled"]:
            raise AssertionError(f"tp_decode f32: n_model {n} differs from "
                                 f"n_model 1 in {differ} greedy tokens "
                                 f"(sampled equal: "
                                 f"{run['sampled'] == base['sampled']})")
        if run["hits"] <= 0 or run["graph"]["replayed"] <= 0:
            raise AssertionError(f"tp_decode n_model {n}: radix hits "
                                 f"{run['hits']}, replays {run['graph']}")
        if run["launches"] != n * base["launches"] or base["launches"] <= 0:
            raise AssertionError(f"tp_decode n_model {n}: K3 launched "
                                 f"{run['launches']} times, n_model 1 "
                                 f"{base['launches']}")

    # bf16: the n_model 1 pool's streams teacher-forced through each
    # tensor-parallel decoder (and the f32 model, for scale)
    model16 = build_lm(cfg, "bf16", depth=cfg["depth"], seed=TP["seed"])
    ref16 = tp_streams(model16, greedy, max_new, **kw)
    total += ref16["launches"]
    tokens = torch.tensor(ref16["greedy"], device="cuda")
    first = len(greedy[0]) - 1            # the first generated position
    want = teacher_forced_logits(model16, tokens)[:, first:-1]
    f32 = teacher_forced_logits(model, tokens)[:, first:-1]

    def rel(a, b):
        return float(((a - b).abs().amax(-1)
                      / b.abs().amax(-1)).max())

    bf16_vs_f32 = rel(want, f32)
    del model, f32
    torch.cuda.empty_cache()
    for n in TP["n_models"]:
        mesh = meshes[n]
        got = teacher_forced_logits(ShardedLM(model16, mesh), tokens)
        gap = rel(got[:, first:-1], want)
        run = tp_streams(model16, greedy, max_new, mesh=mesh, **kw)
        total += run["launches"]
        gen = [(a != b) for sa, sb in zip(run["greedy"], ref16["greedy"])
               for a, b in zip(sa[first + 1:], sb[first + 1:])]
        say("tp_decode", card=card, dtype="bfloat16", n_model=n,
            teacher_forced_positions=int(want.shape[0] * want.shape[1]),
            max_rel_logit_diff=gap, tolerance=TP["bf16_rel_tol"],
            n_model_1_bf16_vs_f32_max_rel_logit_diff=bf16_vs_f32,
            greedy_token_share_differing=sum(gen) / len(gen),
            k3_launches=run["launches"],
            k3_launches_n_model_1=ref16["launches"],
            decode_tokens_per_s=run["tokens_per_s"],
            decode_tokens_per_s_n_model_1=ref16["tokens_per_s"],
            tokens_per_s_note="informational, a virtual mesh on one card")
        if not gap <= TP["bf16_rel_tol"]:
            raise AssertionError(f"tp_decode bf16: n_model {n} logits off "
                                 f"by {gap} of the largest (tolerance "
                                 f"{TP['bf16_rel_tol']})")
        torch.cuda.empty_cache()
    del model16
    torch.cuda.empty_cache()
    return total


# -- the cluster: nodes as ``python -m idunno_tpu_torch`` builds them -----


def free_port_base(n: int, spread: int = 100) -> int:
    """A port base such that the TCP and UDP ports of ``n`` local nodes
    (``__main__.build_addr_of``: ``spread`` apart) are free now."""
    for base in range(24000 + os.getpid() % 2000, 64000, 777):
        try:
            for i in range(n):
                for off in range(0, 30, 5):
                    for kind in (socket.SOCK_STREAM, socket.SOCK_DGRAM):
                        with socket.socket(socket.AF_INET, kind) as s:
                            s.bind(("127.0.0.1", base + off + spread * i))
        except OSError:
            continue
        return base
    raise RuntimeError("no free port range")


def cluster_json(hosts, base: int) -> dict:
    """The cluster config as ``--config`` takes it: every host local,
    its ports ``100 * index`` above ``base``."""
    return {"hosts": list(hosts), "coordinator": hosts[0],
            "standby_coordinator": hosts[-1], "introducer": hosts[0],
            "ports": {"membership": base, "store": base + 5,
                      "inference": base + 10, "result": base + 15,
                      "metadata": base + 20, "grep": base + 25},
            # generous: a node's heartbeat thread shares the GIL with
            # model loads and serving on the same process
            "ping_interval_s": 0.3, "failure_timeout_s": 10.0,
            "replication_factor": min(2, len(hosts)),
            "query_batch_size": N_QUERY, "query_interval_s": 0.0,
            "metadata_interval_s": 0.5,
            "engine": {"batch_size": BATCH, "image_size": CROP,
                       "resize_size": SIDE}}


def control_port(base: int, index: int) -> int:
    """A node's control RPC: its one TCP listener (the store port)."""
    return base + 5 + 100 * index


def rpc(port: int, verb: str, timeout: float = 120.0, **kw) -> dict:
    """One control verb over a socket (``comm.net.oneshot_call``); fails
    on an error reply."""
    from idunno_tpu_torch.comm.message import Message
    from idunno_tpu_torch.comm.net import oneshot_call
    from idunno_tpu_torch.utils.types import MessageType

    out = oneshot_call("127.0.0.1", port, "control",
                       Message(MessageType.INFERENCE, "chip_smoke",
                               {"verb": verb, **kw}), timeout=timeout)
    if out is None or out.type is not MessageType.ACK:
        raise AssertionError(f"control {verb}: "
                             f"{None if out is None else out.payload}")
    return out.payload


def wait_converged(port: int, hosts, seconds: float = 120.0,
                   proc=None) -> dict:
    """Poll ``status`` until every host is RUNNING in the node's view."""
    from idunno_tpu_torch.comm.transport import TransportError

    deadline = time.monotonic() + seconds
    while True:
        try:
            st = rpc(port, "status", timeout=5.0)
            if (sorted(st["members"]) == sorted(hosts)
                    and set(st["members"].values()) == {"RUNNING"}):
                return st
        except (AssertionError, OSError, TransportError):
            pass                     # boot window: not serving yet
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"node process exited {proc.returncode}")
        if time.monotonic() > deadline:
            raise AssertionError(f"membership never converged: {hosts}")
        time.sleep(0.2)


def lm_blob(model, path: str) -> str:
    """``save_lm``'s blob of ``model`` written to a file, for ``put``."""
    from idunno_tpu_torch.engine.generate import save_lm

    class _File:
        def put_bytes(self, name, blob):
            with open(path, "wb") as f:
                f.write(blob)
            return 1

    save_lm(_File(), "blob", model)
    return path


def pool_payload(cfg: dict, buckets) -> dict:
    """Phase 8's pool (``lm_pool_kw``) as ``lm_serve`` keys."""
    kw = lm_pool_kw(cfg, buckets)
    kw["prompt_buckets"] = list(kw["prompt_buckets"])
    return dict(kw, paged_kernel="auto", warmup=True)


def serve_via_rpc(port: int, name: str, prompts, max_new: int,
                  clients: int = 1) -> tuple:
    """Submit ``prompts`` to pool ``name`` from ``clients`` threads over
    the RPC and poll until all are done: (completions by id, client
    submit stamps by id, wall seconds)."""
    submitted, errors, lock = {}, [], threading.Lock()

    def client(ps):
        try:
            for p in ps:
                t = time.monotonic()
                rid = rpc(port, "lm_submit", name=name, prompt=p,
                          max_new=max_new)["id"]
                with lock:
                    submitted[rid] = (t, p)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{type(e).__name__}: {e}")

    done = {}
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(prompts[i::clients],))
               for i in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    deadline = time.monotonic() + 600
    while len(done) < len(prompts) and not errors:
        reply = rpc(port, "lm_poll", name=name)
        errors.extend(reply.get("errors", []))
        for c in reply["completions"]:
            done[c["id"]] = c
        if time.monotonic() > deadline:
            raise AssertionError(f"{len(done)} of {len(prompts)} done")
        time.sleep(0.005)
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"pool {name}: {errors[:5]}")
    if sorted(done) != sorted(submitted):
        raise AssertionError(f"pool {name}: done {sorted(done)}, "
                             f"submitted {sorted(submitted)}")
    return done, submitted, wall


def cnn_queries(port: dict) -> tuple:
    """Concurrent ``inference`` verbs, resnet at n2 and alexnet at n1,
    1,024 images each; polls ``query_done`` at the master, fetches
    ``results``: (records by model, provenance at the master, wall s)."""
    qnums = {}

    def submit(host, model):
        qnums[model] = rpc(port[host], "inference", model=model, start=0,
                           end=N_QUERY - 1)["qnums"]

    t0 = time.perf_counter()
    threads = [threading.Thread(target=submit, args=hm)
               for hm in (("n2", "resnet"), ("n1", "alexnet"))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if set(qnums) != {"resnet", "alexnet"}:
        raise AssertionError(f"inference verbs answered {qnums}")
    pending = {(m, q) for m, qs in qnums.items() for q in qs}
    deadline = time.monotonic() + 300
    while pending:
        for m, q in sorted(pending):
            st = rpc(port["n0"], "query_done", model=m, qnum=q)
            if st["failed"]:
                raise AssertionError(f"{m} query {q} failed")
            if st["done"]:
                pending.discard((m, q))
        if time.monotonic() > deadline:
            raise AssertionError(f"queries not done: {pending}")
        time.sleep(0.02)
    records, weights = {}, {}
    for m, qs in qnums.items():
        for q in qs:
            res = rpc(port["n0"], "results", model=m, qnum=q)
            records.setdefault(m, []).extend(res["records"])
            weights = res["weights"]
    wall = time.perf_counter() - t0
    want = {f"test_{i}.JPEG" for i in range(N_QUERY)}
    for m, recs in records.items():
        if len(recs) != N_QUERY or {r[0] for r in recs} != want:
            raise AssertionError(f"{m}: {len(recs)} records of {N_QUERY}")
        if not all(isinstance(c, str) and math.isfinite(p) and 0.0 <= p <= 1.0
                   for _, c, p in recs):
            raise AssertionError(f"{m}: malformed record")
    return records, weights, wall


def cluster_cnn(nodes: dict, port: dict, card: str) -> int:
    """n0 publishes ResNet-18's seeded weights; the CNN queries run twice
    through the cluster: cold (each worker's first task loads its models,
    resnet from the store) and warm (phase 4 warms its engine first).
    Returns K1's launches in both."""
    nodes["n0"].engine.load("resnet")
    version = nodes["n0"].engine.publish_weights("resnet", allow_random=True)
    zero_launches()
    cold, _, cold_s = cnn_queries(port)
    warm, weights, warm_s = cnn_queries(port)
    launches = read_launches()["preprocess"]
    # every worker that served resnet, the publisher aside (its seeded
    # weights ARE the published ones, marked "random"), read it from the
    # store
    served = {h: n.engine.weights_provenance("resnet")
              for h, n in nodes.items()}
    readers = {h: w for h, w in served.items()
               if h != "n0" and w != "unknown"}
    if not readers or set(readers.values()) != {"store"}:
        raise AssertionError(f"resnet provenance by worker: {served}")
    if any(sorted(cold[m]) != sorted(warm[m]) for m in cold):
        raise AssertionError("the warm round's records differ from the "
                             "cold round's")
    if launches < 2 * 2 * N_QUERY // BATCH:
        raise AssertionError(f"K1 launched {launches} times for "
                             f"{2 * 2 * N_QUERY} images")
    images = 2 * N_QUERY
    say("cluster_cnn", card=card, images_a_round=images, cold_wall_s=cold_s,
        warm_wall_s=warm_s, images_per_s_through_rpc_cold=images / cold_s,
        images_per_s_through_rpc_warm=images / warm_s,
        images_per_s_in_process=IN_PROCESS.get("images_per_s"),
        preprocess_launches=launches, published_version=version,
        resnet_weights_by_worker=served, weights_at_master=weights)
    return launches


def cluster_lm(nodes: dict, port: dict, cfg: dict, card: str,
               root: str) -> int:
    """The full-width bf16 LM through the store and the LM verbs on n0:
    ``put`` of its blob, ``lm_serve`` of phase 8's pool, the 48
    shared-prefix requests from two client threads, ``generate`` against
    the same model in this process; returns K3's launches."""
    import torch

    from idunno_tpu_torch.engine.generate import generate, lm_store_name
    from idunno_tpu_torch.utils.lm_bench import (prefix_bench_workload,
                                                 serving_max_new)

    model = build_lm(cfg, "bf16", depth=cfg["depth"], seed=0)
    t0 = time.perf_counter()
    path = lm_blob(model, os.path.join(root, "lm.blob"))
    blob_bytes = os.path.getsize(path)
    rpc(port["n1"], "put", local=path, name=lm_store_name("lm"))
    put_s = time.perf_counter() - t0
    prompts, _, buckets = prefix_bench_workload(cfg, LM_BLOCK)
    max_new = serving_max_new(cfg)
    t0 = time.perf_counter()
    rpc(port["n0"], "lm_serve", name="lm", timeout=600.0,
        **pool_payload(cfg, buckets))
    serve_s = time.perf_counter() - t0
    zero_launches()
    done, submitted, wall = serve_via_rpc(port["n0"], "lm", prompts,
                                          max_new, clients=2)
    launches = read_launches()["paged_attention"]
    stats = rpc(port["n0"], "lm_stats", name="lm")["stats"]
    want_len = cfg["prompt_len"] + max_new
    for c in done.values():
        if (len(c["tokens"]) != want_len or c["cancelled"]
                or not all(0 <= x < cfg["vocab"] for x in c["tokens"])):
            raise AssertionError(f"request {c['id']}: {len(c['tokens'])} "
                                 f"tokens, want {want_len} in the vocab")
    hits, graph = stats["prefix_cache"]["hits"], stats["decode_graph"]
    if hits <= 0 or launches <= 0 or (graph["mode"] == "graph"
                                      and graph["replayed"] <= 0):
        raise AssertionError(f"radix hits {hits}, K3 launches {launches}, "
                             f"graph {graph}")
    ttft_rpc, ttft_server = [], []
    for rid, (t_submit, _) in submitted.items():
        spans = {s["name"]: s for s in rpc(port["n0"], "trace", name="lm",
                                           id=rid)["spans"]}
        ttft_rpc.append(spans["lm.prefill"]["t_end"] - t_submit)
        ttft_server.append(spans["lm.prefill"]["t_end"]
                           - spans["lm.admit"]["t_start"])
    ttft_rpc.sort()
    ttft_server.sort()
    gen = sum(len(c["tokens"]) - c["prompt_len"] for c in done.values())

    def pct(xs, q):
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    profile = profile_via_rpc(port["n0"], prompts, max_new, root)
    rpc(port["n0"], "lm_stop", name="lm")
    # greedy `generate` through the verb against this process's model
    few = prompts[:CLUSTER_GEN["prompts"]]
    t0 = time.perf_counter()
    got = rpc(port["n0"], "generate", name="lm", prompt=few,
              max_new=CLUSTER_GEN["max_new"], timeout=600.0)["tokens"]
    generate_s = time.perf_counter() - t0
    ref = generate(model, torch.tensor(few), len(few[0]),
                   CLUSTER_GEN["max_new"]).tolist()
    if got != ref:
        raise AssertionError("generate through the RPC differs from this "
                             "process's generate of the same model")
    say("cluster_lm", card=card, requests=len(done), max_new=max_new,
        blob_bytes=blob_bytes, put_s=put_s, lm_serve_s=serve_s,
        wall_s=wall, tokens_generated=gen,
        tokens_per_s_through_rpc=gen / wall,
        tokens_per_s_in_process=IN_PROCESS.get("tokens_per_s"),
        ttft_p50_s_through_rpc=pct(ttft_rpc, 0.5),
        ttft_p95_s_through_rpc=pct(ttft_rpc, 0.95),
        ttft_p50_s_server_side=pct(ttft_server, 0.5),
        ttft_p95_s_server_side=pct(ttft_server, 0.95),
        ttft_p50_s_in_process=IN_PROCESS.get("ttft_p50_s"),
        ttft_p95_s_in_process=IN_PROCESS.get("ttft_p95_s"),
        paged_launches=launches, radix_hits=hits,
        dispatches=stats["dispatches"], decode_graph=graph,
        generate_prompts=len(few), generate_s=generate_s,
        generate_equal=True, profile=profile)
    del model
    return launches


PROFILE_S = 2.0                  # the `profile` verb's window in `cluster_lm`


def profile_via_rpc(port: int, prompts, max_new: int, root: str) -> dict:
    """The ``profile`` verb on the node at ``port`` for ``PROFILE_S``
    seconds, started while its pool ``lm`` serves ``prompts`` again from
    two client threads; the Chrome trace it writes must hold the pool's
    K3 (``paged_fwd``) kernels. Returns what the trace holds."""
    import glob
    import gzip

    log_dir = os.path.join(root, "profile")
    reply: dict = {}

    def verb():
        try:
            reply.update(rpc(port, "profile", seconds=PROFILE_S,
                             log_dir=log_dir))
        except Exception as e:  # noqa: BLE001 - reported below
            reply["error"] = f"{type(e).__name__}: {e}"

    th = threading.Thread(target=verb)
    th.start()
    time.sleep(0.2)                        # the trace starts first
    serve_via_rpc(port, "lm", prompts, max_new, clients=2)
    th.join(120)
    if th.is_alive() or reply != {"log_dir": log_dir, "seconds": PROFILE_S}:
        raise AssertionError(f"profile verb: {reply}")
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json.gz"))
    if len(files) != 1:
        raise AssertionError(f"profile verb wrote {files}")
    with gzip.open(files[0], "rt") as f:
        events = json.load(f)["traceEvents"]
    k3 = [e for e in events if e.get("cat") == "kernel"
          and "paged_fwd" in e.get("name", "")]
    out = {"trace_bytes": os.path.getsize(files[0]), "events": len(events),
           "k3_kernels": len(k3),
           "kernels": sum(e.get("cat") == "kernel" for e in events),
           "cpu_op_threads": len({e.get("tid") for e in events
                                  if e.get("cat") == "cpu_op"})}
    if not k3:
        raise AssertionError(f"the profile verb's trace holds no K3 kernel: "
                             f"{out}")
    return out


def cluster_exactness(port: dict, cfg: dict, root: str):
    """Full width, depth 2, f32: the shared-prefix workload through the LM
    verbs must give the greedy streams of an in-process paged
    DecodeServer. Returns (the model, its blob file) for the entry-point
    check."""
    import torch

    from idunno_tpu_torch.engine.generate import lm_store_name
    from idunno_tpu_torch.utils.lm_bench import (prefix_bench_workload,
                                                 serving_max_new)

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_lm(cfg, "f32", depth=2, seed=1)
    path = lm_blob(model, os.path.join(root, "lm32.blob"))
    rpc(port["n2"], "put", local=path, name=lm_store_name("lm32"))
    prompts, _, buckets = prefix_bench_workload(cfg, LM_BLOCK)
    max_new = serving_max_new(cfg)
    rpc(port["n0"], "lm_serve", name="lm32", timeout=600.0,
        **pool_payload(cfg, buckets))
    done, submitted, _ = serve_via_rpc(port["n0"], "lm32", prompts, max_new)
    by_prompt = {tuple(p): done[rid]["tokens"]
                 for rid, (_, p) in submitted.items()}
    rpc(port["n0"], "lm_stop", name="lm32")
    ref, hits, graph = serve_streams(model, prompts, max_new,
                                     paged_kernel="auto",
                                     **lm_pool_kw(cfg, buckets))
    hold_equal("cluster_exactness",
               {"in_process": ref,
                "via_rpc": [by_prompt[tuple(p)] for p in prompts]},
               depth=2, dtype="float32", radix_hits_in_process=hits,
               replayed_in_process=graph["replayed"])
    return model, path


# the cluster KV tier: the served pools add a 512-token bucket for the
# handoff legs, and blocks for the 512-token chains they ship
KV_LONG = {"prompts": 4, "len": 512, "max_new": 16}
KV_POOL_BLOCKS = 256


def kv_pool_payload(cfg: dict, buckets) -> dict:
    """Phase 8's pool (``pool_payload``) of the stored bf16 LM ``lm`` with
    the cluster prefix cache on, one more prompt bucket for
    ``KV_LONG["len"]``-token prompts (prompt_len and max_len raised to fit
    them) and ``KV_POOL_BLOCKS`` KV blocks."""
    from idunno_tpu_torch.utils.lm_bench import serving_max_new

    spec = pool_payload(cfg, buckets)
    spec["prompt_buckets"] = sorted(set(spec["prompt_buckets"])
                                    | {KV_LONG["len"]})
    spec.update(model="lm", prompt_len=KV_LONG["len"],
                max_len=max(spec["max_len"],
                            KV_LONG["len"] + serving_max_new(cfg)),
                kv_cache_blocks=KV_POOL_BLOCKS,
                cluster_prefix={"publish_min_hits": 1})
    return spec


def cluster_kv(port: dict, cfg: dict, card: str) -> int:
    """The cluster KV tier through the RPC on the full-width bf16 LM
    (``lm``, put by ``cluster_lm``), KV blocks of 16: (a) pool kv1 on n1
    serves the 48 shared-prefix requests and publishes their chains; (b)
    pool kv2 on n2 probes them (same namespace, 0 local and ≥ 3 remote
    blocks), its first admission prefills one suffix bucket, then it
    serves the other 47 with remote hits; (c) pool kv3 on n0 warms from
    the tenant index before any request; (d) ``kv_handoff`` ``ship`` of
    512-token prompts from kv1 to kv2, whose admissions of them then
    prefill one suffix bucket each, with no fallback. Returns K3's
    launches over (a)-(d)."""
    from idunno_tpu_torch.utils.lm_bench import (prefix_bench_workload,
                                                 serving_max_new)

    prompts, shared, buckets = prefix_bench_workload(cfg, LM_BLOCK)
    max_new = serving_max_new(cfg)
    spec = kv_pool_payload(cfg, buckets)
    suffix_bucket = min(b for b in buckets if b >= cfg["prompt_len"] - shared)
    out: dict = {"pool": spec}
    zero_launches()
    # (a) the publisher
    t0 = time.perf_counter()
    rpc(port["n1"], "lm_serve", name="kv1", timeout=600.0, **spec)
    out["lm_serve_s"] = time.perf_counter() - t0
    done1, _, wall = serve_via_rpc(port["n1"], "kv1", prompts, max_new,
                                   clients=2)
    st1 = rpc(port["n1"], "lm_stats", name="kv1")["stats"]
    pc1 = st1["prefix_cache"]
    gen = sum(len(c["tokens"]) - c["prompt_len"] for c in done1.values())
    out["a"] = {"requests": len(done1), "wall_s": wall,
                "tokens_per_s": gen / wall, "radix_hits": pc1["hits"],
                "published_chains": pc1["prefix_published_chains"],
                "published_blocks": pc1["prefix_published_blocks"],
                "prefill_tokens": st1["prefill_tokens"]}
    if pc1["prefix_published_chains"] <= 0:
        raise AssertionError(f"kv1 published no chain: {pc1}")
    # (b) the consumer: the same stored LM on another node
    rpc(port["n2"], "lm_serve", name="kv2", timeout=600.0, **spec)
    probe1 = rpc(port["n1"], "prefix_probe", name="kv1", tokens=prompts[0])
    t0 = time.perf_counter()
    probe2 = rpc(port["n2"], "prefix_probe", name="kv2", tokens=prompts[0])
    probe_s = time.perf_counter() - t0
    if (probe2["namespace"] != probe1["namespace"]
            or probe2["local_blocks"] != 0 or probe2["remote_blocks"] < 3):
        raise AssertionError(f"kv2 probe {probe2} against kv1's {probe1}")
    first, _, first_s = serve_via_rpc(port["n2"], "kv2", prompts[:1], max_new)
    st2 = rpc(port["n2"], "lm_stats", name="kv2")["stats"]
    first_prefill = st2["prefill_tokens"]
    if first_prefill != suffix_bucket or \
            st2["prefix_cache"]["prefix_remote_hits"] != 1:
        raise AssertionError(
            f"kv2's first admission prefilled {first_prefill} tokens (want "
            f"the {suffix_bucket}-token suffix bucket), remote hits "
            f"{st2['prefix_cache']['prefix_remote_hits']}")
    rest, _, wall = serve_via_rpc(port["n2"], "kv2", prompts[1:], max_new,
                                  clients=2)
    done2 = {**first, **rest}
    st2 = rpc(port["n2"], "lm_stats", name="kv2")["stats"]
    pc2 = st2["prefix_cache"]
    if len(done2) != len(prompts) or pc2["prefix_remote_hits"] <= 0:
        raise AssertionError(f"kv2: {len(done2)} done, {pc2}")
    by_prompt1 = {tuple(c["tokens"][:c["prompt_len"]]): c["tokens"]
                  for c in done1.values()}
    same = sum(by_prompt1.get(tuple(c["tokens"][:c["prompt_len"]]))
               == c["tokens"] for c in done2.values())
    gen = sum(len(c["tokens"]) - c["prompt_len"] for c in rest.values())
    out["b"] = {"namespace": probe2["namespace"], "probe": probe2,
                "probe_s": probe_s, "first_request_s": first_s,
                "first_prefill_tokens": first_prefill,
                "prompt_len": cfg["prompt_len"],
                "remote_hits": pc2["prefix_remote_hits"],
                "fetch_bytes": pc2["prefix_fetch_bytes"],
                "store_errors": pc2["prefix_store_errors"],
                "radix_hits": pc2["hits"], "wall_s_47": wall,
                "tokens_per_s_47": gen / wall,
                "streams_equal_to_kv1": same, "requests": len(done2)}
    # (c) warm at spawn from the tenant index
    rpc(port["n0"], "lm_serve", name="kv3", timeout=600.0, **spec)
    t0 = time.perf_counter()
    warm = rpc(port["n0"], "prefix_fetch", name="kv3", tenant="default")
    out["c"] = dict(warm, seconds=time.perf_counter() - t0)
    if warm["fetched_blocks"] <= 0:
        raise AssertionError(f"kv3 warmed nothing: {warm}")
    # (d) prefill on kv1, ship to kv2, admit there
    rng = random.Random(11)
    longs = [[rng.randrange(1, cfg["vocab"]) for _ in range(KV_LONG["len"])]
             for _ in range(KV_LONG["prompts"])]
    ships = []
    for p in longs:
        t0 = time.perf_counter()
        shipped = rpc(port["n1"], "kv_handoff", op="ship", name="kv1",
                      target_host="n2", target_name="kv2", tokens=p,
                      timeout=600.0)
        ships.append(dict(shipped, seconds=time.perf_counter() - t0))
    want = (KV_LONG["len"] - 1) // LM_BLOCK
    if any(sh["shipped"] != want or sh["target_depth"] != want
           for sh in ships):
        raise AssertionError(f"ships {ships}, want {want} blocks each")
    before = rpc(port["n2"], "lm_stats", name="kv2")["stats"]["prefill_tokens"]
    done_d, _, _ = serve_via_rpc(port["n2"], "kv2", longs, KV_LONG["max_new"])
    st2 = rpc(port["n2"], "lm_stats", name="kv2")["stats"]
    st1 = rpc(port["n1"], "lm_stats", name="kv1")["stats"]
    d_prefill = st2["prefill_tokens"] - before
    tail = KV_LONG["len"] - want * LM_BLOCK
    tail_bucket = min(b for b in spec["prompt_buckets"] if b >= tail)
    launches = read_launches()["paged_attention"]
    blocks = sum(sh["shipped"] for sh in ships)
    nbytes = sum(sh["bytes"] for sh in ships)
    out["d"] = {"prompts": len(longs), "prompt_len": KV_LONG["len"],
                "blocks": blocks, "bytes": nbytes,
                "bytes_per_block": nbytes / blocks,
                "ship_s": [sh["seconds"] for sh in ships],
                "ship_mb_per_s": nbytes / sum(sh["seconds"] for sh in ships)
                / 1e6,
                "prefill_tokens_after_adopt": d_prefill,
                "suffix_bucket": tail_bucket,
                "kv_handoff_requests": st1["kv_handoff_requests"],
                "kv_handoff_fallbacks": [st1["kv_handoff_fallbacks"],
                                         st2["kv_handoff_fallbacks"]],
                "requests": len(done_d)}
    if d_prefill != len(longs) * tail_bucket:
        raise AssertionError(f"kv2 prefilled {d_prefill} tokens for "
                             f"{len(longs)} adopted prompts")
    if st1["kv_handoff_fallbacks"] or st2["kv_handoff_fallbacks"]:
        raise AssertionError(f"handoff fallbacks {out['d']}")
    for name, host in (("kv1", "n1"), ("kv2", "n2"), ("kv3", "n0")):
        rpc(port[host], "lm_stop", name=name)
    if launches <= 0:
        raise AssertionError("K3 launched no time in the cluster KV phase")
    say("cluster_kv", card=card, paged_launches=launches, **out)
    return launches


def cluster_kv_exactness(nodes: dict, cfg: dict, card: str) -> None:
    """(e) Full width, depth 2, f32, the shared-prefix workload, for K3
    (``kernel``) and the plain paged attention: a pool that prefilled
    itself, a publisher to the store (n0's), a pool fed by remote hits
    from it (n1's store), and a pool fed by adopted handoffs from it give
    equal greedy streams; the fed pools hit remotely and prefill only
    suffixes."""
    import torch

    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.serve.cluster_prefix import ClusterPrefixCache
    from idunno_tpu_torch.utils.lm_bench import (prefix_bench_workload,
                                                 serving_max_new)

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_lm(cfg, "f32", depth=2, seed=1)
    prompts, _, buckets = prefix_bench_workload(cfg, LM_BLOCK)
    max_new = serving_max_new(cfg)
    kw = lm_pool_kw(cfg, buckets)

    def run(srv):
        ids = [srv.submit(p, max_new=max_new) for p in prompts]
        done = {c.id: c.tokens for c in srv.run_until_drained()}
        return [done[i] for i in ids]

    streams, fed = {}, {}
    for kernel in ("kernel", "plain"):
        streams[f"{kernel}/self"], _, _ = serve_streams(
            model, prompts, max_new, paged_kernel=kernel, **kw)
        ns = f"chip-smoke-exactness-{kernel}"
        pub = DecodeServer(model, device="cuda", paged_kernel=kernel, **kw)
        pub.cluster_prefix = ClusterPrefixCache(nodes["n0"].store, ns,
                                                LM_BLOCK, publish_min_hits=0)
        streams[f"{kernel}/publisher"] = run(pub)
        sub = DecodeServer(model, device="cuda", paged_kernel=kernel, **kw)
        sub.cluster_prefix = ClusterPrefixCache(nodes["n1"].store, ns,
                                                LM_BLOCK)
        streams[f"{kernel}/remote_hit"] = run(sub)
        dec = DecodeServer(model, device="cuda", paged_kernel=kernel, **kw)
        adopted = 0
        for p in prompts:
            d0 = dec.handoff_probe(p)["depth"]
            exp = pub.handoff_export(p, from_depth=d0)
            adopted += dec.handoff_adopt(p, exp["blobs"],
                                         start_depth=d0)["wrote"]
        streams[f"{kernel}/adopted"] = run(dec)
        fed[kernel] = {
            "remote_hits": sub.prefix_cache_stats()["prefix_remote_hits"],
            "remote_hit_prefill_tokens": sub.stats()["prefill_tokens"],
            "adopted_blocks": adopted,
            "adopted_prefill_tokens": dec.stats()["prefill_tokens"],
            "self_prefill_tokens": pub.stats()["prefill_tokens"]}
        del pub, sub, dec
        torch.cuda.empty_cache()
    hold_equal("cluster_kv_exactness", streams, card=card, depth=2,
               dtype="float32", fed=fed)
    for kernel, f in fed.items():
        if (f["remote_hits"] <= 0 or f["adopted_blocks"] <= 0
                or f["adopted_prefill_tokens"] >= f["self_prefill_tokens"]
                or f["remote_hit_prefill_tokens"]
                >= f["self_prefill_tokens"]):
            raise AssertionError(f"{kernel}: pools not fed: {f}")
    del model


# the training job: the LM bench's widths at depth 4 (its f32 train state,
# 12 B a parameter, stays under the store's 2 GiB frame), f32 parameters
# and bf16 compute, the train bench's seq and batch
TRAIN_JOB = {"depth": 4, "seq_len": 1024, "batch_size": 8, "steps": 12,
             "checkpoint_every": 4, "lr": 1e-3, "corpus_tokens": 2_000_000}


def cluster_train(nodes: dict, port: dict, cfg: dict, card: str,
                  root: str) -> None:
    """``train_start`` of the full-width LM at depth 4 on n1 from a
    seeded 2M-token corpus in the store, ``train_stop`` once it has
    checkpointed, ``train_start(resume=True)`` on n2 to the end, and
    ``generate`` of the trained LM through n0 equal to this process's
    ``load_lm`` + ``generate``; then a full-depth job, whose train state is
    over the store's frame cap, must end in a typed error naming the cap.
    Step and checkpoint times come from wrappers of the job's step and
    ``save_train_state`` in this process (the nodes run in it)."""
    import numpy as np
    import torch

    from idunno_tpu_torch.engine import checkpoint, train_lm
    from idunno_tpu_torch.engine.generate import generate, load_lm

    rng = np.random.default_rng(23)
    # Zipf-distributed tokens: a corpus whose unigram statistics a few
    # steps can learn, so a falling loss means the job trained
    corpus = np.minimum(rng.zipf(1.3, TRAIN_JOB["corpus_tokens"]),
                        cfg["vocab"] - 1).astype(np.int32)
    path = os.path.join(root, "corpus.bin")
    corpus.tofile(path)
    rpc(port["n0"], "put", local=path, name="corpus/chip")
    model = {"vocab": cfg["vocab"], "dim": cfg["dim"],
             "depth": TRAIN_JOB["depth"], "num_heads": cfg["heads"],
             "dtype": "bfloat16", "param_dtype": "float32"}
    job = {k: TRAIN_JOB[k] for k in ("seq_len", "batch_size",
                                     "checkpoint_every", "lr")}
    steps_ms, saves = [], []
    real_save, real_make = (checkpoint.save_train_state,
                            train_lm.make_lm_train_step)

    def timed_save(store, name, state):
        t0 = time.perf_counter()
        version = real_save(store, name, state)
        dt = time.perf_counter() - t0
        size = next((os.path.getsize(p) for p in (
            n.store.local._path(checkpoint.train_state_name(name), version)
            for n in nodes.values()) if os.path.exists(p)), None)
        saves.append({"job": name, "step": int(state.step),
                      "version": version, "seconds": dt, "bytes": size})
        return version

    def timed_make(model_, optimizer, **kw):
        step = real_make(model_, optimizer, **kw)

        def timed(state, tokens):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, tokens)
            float(metrics["loss"])
            steps_ms.append((time.perf_counter() - t0) * 1e3)
            return metrics
        return timed

    def wait(host, name, until, seconds):
        deadline = time.monotonic() + seconds
        while True:
            st = rpc(port[host], "train_status", name=name)
            if until(st):
                return st
            if st["error"] and not until(st):
                raise AssertionError(f"job {name}: {st['error']}")
            if time.monotonic() > deadline:
                raise AssertionError(f"job {name} after {seconds} s: {st}")
            time.sleep(0.05)

    checkpoint.save_train_state = timed_save
    train_lm.make_lm_train_step = timed_make
    t_job = time.perf_counter()
    try:
        rpc(port["n1"], "train_start", name="trained", corpus="corpus/chip",
            model=model, steps=TRAIN_JOB["steps"], **job)
        wait("n1", "trained",
             lambda st: st["checkpoint_version"] is not None, 600)
        if not rpc(port["n1"], "train_stop", name="trained",
                   timeout=600.0)["stopped"]:
            raise AssertionError("train_stop found no job")
        # the stopped job writes its last checkpoint before it reports
        stopped = wait("n1", "trained", lambda s: s["stopped"] or s["done"],
                       600)
        if not stopped["stopped"]:
            raise AssertionError(f"the job finished before its stop: "
                                 f"{stopped}")
        rpc(port["n2"], "train_start", name="trained", corpus="corpus/chip",
            model=model, steps=TRAIN_JOB["steps"], resume=True, **job)
        st = wait("n2", "trained", lambda s: s["done"], 900)
        job_s = time.perf_counter() - t_job
    finally:
        checkpoint.save_train_state = real_save
        train_lm.make_lm_train_step = real_make
    if not (st["start_step"] >= TRAIN_JOB["checkpoint_every"]
            and st["step"] == TRAIN_JOB["steps"]
            and st["served_version"] is not None
            and math.isfinite(st["loss"]) and st["loss"] < st["first_loss"]):
        raise AssertionError(f"resumed job: {st}")
    few = [[int(t) for t in corpus[i * 64:(i + 1) * 64]]
           for i in range(CLUSTER_GEN["prompts"])]
    got = rpc(port["n0"], "generate", name="trained", prompt=few,
              max_new=CLUSTER_GEN["max_new"], timeout=600.0)["tokens"]
    trained = load_lm(nodes["n0"].store, "trained")
    ref = generate(trained, torch.tensor(few), len(few[0]),
                   CLUSTER_GEN["max_new"]).tolist()
    if got != ref:
        raise AssertionError("generate of the trained LM through the RPC "
                             "differs from this process's")
    n_params = sum(p.numel() for p in trained.parameters())
    del trained
    torch.cuda.empty_cache()
    steady = sorted(steps_ms[1:])
    say("cluster_train", card=card, model=model, job=job,
        reduced={"depth": f"{TRAIN_JOB['depth']} of {cfg['depth']}: the "
                 "f32 train state (parameters and two Adam moments, 12 B a "
                 "parameter) must fit one store frame of 2 GiB "
                 "(comm/net.py:_MAX_FRAME); at full depth it is 2.62 GB"},
        n_params=n_params, corpus_tokens=TRAIN_JOB["corpus_tokens"],
        stopped_at=stopped["step"], start_step=st["start_step"],
        steps=st["step"], first_loss=st["first_loss"], loss=st["loss"],
        stopped_first_loss=stopped["first_loss"],
        step_ms=steps_ms, step_ms_median=steady[len(steady) // 2],
        tokens_per_s=TRAIN_JOB["batch_size"] * TRAIN_JOB["seq_len"]
        / (steady[len(steady) // 2] / 1e3),
        checkpoints=saves, job_wall_s=job_s,
        served_version=st["served_version"], generate_equal=True)

    # the full-depth job fails typed at its first checkpoint, and nothing
    # hangs: the status names the cap within the timeout
    full = dict(model, depth=cfg["depth"])
    t0 = time.perf_counter()
    rpc(port["n1"], "train_start", name="full_depth", corpus="corpus/chip",
        model=full, steps=2, **dict(job, checkpoint_every=1))
    st = wait("n1", "full_depth", lambda s: s["error"] is not None, 600)
    err_s = time.perf_counter() - t0
    say("cluster_train_full_depth", card=card, model=full, error=st["error"],
        step=st["step"], seconds_to_error=err_s, timeout_s=600)
    if not (st["error"].startswith("ValueError")
            and "comm/net.py:_MAX_FRAME" in st["error"] and not st["done"]):
        raise AssertionError(f"full-depth job: {st}")
    torch.cuda.empty_cache()


def cluster_entry_point(model, blob: str, cfg: dict, card: str) -> dict:
    """``python -m idunno_tpu_torch --host n0 --config <one host>
    --no-shell`` as a subprocess, without ``--cpu``: the f32 depth-2 LM
    ``put`` from its blob file, greedy ``generate`` through the RPC equal
    to this process's; the subprocess's pid among the card's compute
    apps while it serves."""
    import torch

    from idunno_tpu_torch.engine.generate import generate, lm_store_name
    from idunno_tpu_torch.utils.lm_bench import prefix_bench_workload

    root = tempfile.mkdtemp(prefix="chip_smoke_node_")
    base = free_port_base(1)
    cfg_path = os.path.join(root, "cluster.json")
    with open(cfg_path, "w") as f:
        json.dump(cluster_json(("n0",), base), f)
    err_path = os.path.join(root, "n0.err")
    port = control_port(base, 0)
    t0 = time.perf_counter()
    with open(err_path, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "idunno_tpu_torch", "--host", "n0",
             "--config", cfg_path, "--no-shell",
             "--data-dir", os.path.join(root, "n0")],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.DEVNULL, stderr=err)
    try:
        status = wait_converged(port, ("n0",), proc=proc)
        boot_s = time.perf_counter() - t0
        if status["device"] != "cuda":
            raise AssertionError(f"entry point runs on {status['device']}")
        rpc(port, "put", local=blob, name=lm_store_name("lm32"))
        few = prefix_bench_workload(cfg, LM_BLOCK)[0][:CLUSTER_GEN["prompts"]]
        got = rpc(port, "generate", name="lm32", prompt=few,
                  max_new=CLUSTER_GEN["max_new"], timeout=300.0)["tokens"]
        apps = compute_apps()
        ref = generate(model, torch.tensor(few), len(few[0]),
                       CLUSTER_GEN["max_new"]).tolist()
        if got != ref:
            raise AssertionError("the entry point's generate differs from "
                                 "this process's")
    except Exception:
        with open(err_path, "rb") as f:
            print(f.read()[-4000:].decode(errors="replace"), file=sys.stderr)
        raise
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    after = compute_apps()
    for _ in range(20):          # the context goes when the process exits
        if len(after) < len(apps):
            break
        time.sleep(0.5)
        after = compute_apps()
    # the subprocess held a context on the card: its pid is among the
    # compute apps while it serves; where nvidia-smi cannot name pids in
    # this pid namespace (it then reports others, e.g. 1), the apps it
    # lists are one more while the subprocess serves than after
    if str(proc.pid) in apps:
        seen_by = "pid"
    elif str(os.getpid()) not in apps and len(apps) == len(after) + 1:
        seen_by = "count"
    else:
        raise AssertionError(f"entry point {proc.pid} not seen on the card: "
                             f"compute apps {apps} while it served, "
                             f"{after} after")
    out = {"boot_s": boot_s, "pid": proc.pid, "compute_apps_serving": apps,
           "compute_apps_after": after, "seen_on_card_by": seen_by,
           "exit_code": proc.returncode}
    say("cluster_entry_point", card=card, device=status["device"],
        generate_equal=True, **out)
    return out


def compute_apps() -> list[str]:
    """The pids of the card's compute apps as ``nvidia-smi`` names them."""
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()


def phase_cluster(cfg: dict, card: str) -> dict:
    """Three nodes n0, n1, n2 built as ``python -m idunno_tpu_torch``
    builds them (``__main__.build_node``: ``NetTransport`` on free local
    ports, a node each, engines on the card), driven through the control
    RPC only: CNN queries (K1), the full-width LM pool (K3), the f32
    exactness pool; then the entry point as a subprocess. Returns the
    kernels' launches of the CNN queries and the served LM requests."""
    import torch

    from idunno_tpu_torch.__main__ import build_node, load_config

    root = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    base = free_port_base(len(CLUSTER_HOSTS))
    cfg_path = os.path.join(root, "cluster.json")
    with open(cfg_path, "w") as f:
        json.dump(cluster_json(CLUSTER_HOSTS, base), f)
    config, addresses, engine_config = load_config(cfg_path)
    nodes = {h: build_node(h, config, addresses,
                           data_dir=os.path.join(root, f"{h}-data"),
                           engine_config=engine_config)
             for h in CLUSTER_HOSTS}
    port = {h: control_port(base, i) for i, h in enumerate(CLUSTER_HOSTS)}
    t0 = time.perf_counter()
    try:
        for node in nodes.values():
            node.start()
        wait_converged(port["n0"], CLUSTER_HOSTS)
        say("cluster_boot", nodes=list(CLUSTER_HOSTS),
            seconds=time.perf_counter() - t0,
            devices={h: str(n.device) for h, n in nodes.items()})
        launches = {"preprocess": cluster_cnn(nodes, port, card)}
        launches["paged_attention"] = cluster_lm(nodes, port, cfg, card,
                                                 root)
        torch.cuda.empty_cache()
        model, blob = cluster_exactness(port, cfg, root)
        torch.cuda.empty_cache()
        launches["paged_attention"] += cluster_kv(port, cfg, card)
        torch.cuda.empty_cache()
        cluster_kv_exactness(nodes, cfg, card)
        torch.cuda.empty_cache()
        cluster_train(nodes, port, cfg, card, root)
    finally:
        for node in nodes.values():
            node.stop()
    try:
        torch.cuda.empty_cache()
        cluster_entry_point(model, blob, cfg, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("cluster", card=card, seconds=time.perf_counter() - t0, **launches)
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
    # each path's launches, zeroed just before it and read just after,
    # summed over the paths a kernel runs on
    launches = dict.fromkeys(KERNELS, 0)
    launches["preprocess"] += phase_serving(engines["kernel"])
    phase_paths(engines, smi)
    launches["preprocess"] += phase_cnn_int8_s2d(engines["kernel"], smi)
    del engines
    torch.cuda.empty_cache()
    for name, n in phase_vit_serving(smi).items():
        launches[name] += n
    torch.cuda.empty_cache()

    lm_cfg = lm_bench_config()
    lm = build_lm(lm_cfg, "bf16", depth=lm_cfg["depth"], seed=0)
    launches["flash_attention"] += phase_lm_prefill(lm, lm_cfg, smi)
    # replayed (the default on the card), then the same prompts eagerly
    for mode in ("auto", "eager"):
        launches["paged_attention"] += phase_lm_serving(
            lm, lm_cfg, smi, decode_graph=mode)
        torch.cuda.empty_cache()
    launches["paged_attention"] += phase_lm_serving(
        lm, lm_cfg, smi, quantize="int8", n_requests=LM_INT8_REQUESTS)
    torch.cuda.empty_cache()
    # (b) speculative serving with the bench's draft, seeded weights
    launches["paged_attention"] += phase_lm_serving(
        lm, lm_cfg, smi, draft=build_draft(lm_cfg, "bf16", seed=3))
    torch.cuda.empty_cache()
    phase_spec_ceiling(lm, lm_cfg, smi)                       # (c)
    torch.cuda.empty_cache()
    phase_beam(lm, lm_cfg, smi)
    del lm
    torch.cuda.empty_cache()
    for name, n in phase_bench(smi).items():
        launches[name] += n
    phase_lm_exactness(lm_cfg)
    phase_lm_exactness(lm_cfg, quantize="int8")
    phase_spec_exactness(lm_cfg)                              # (a)
    torch.cuda.empty_cache()
    for name, n in phase_cluster(lm_cfg, smi).items():
        launches[name] += n
    torch.cuda.empty_cache()
    launches["paged_attention"] += phase_default_pool(smi)
    torch.cuda.empty_cache()
    launches["paged_attention"] += phase_tp_decode(lm_cfg, smi)
    torch.cuda.empty_cache()
    train = phase_lm_train(smi)
    for name in ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        launches[name] += train[name]
    # the routed FFN: prefill through K2, training through K2/K4/K5, served
    launches["flash_attention"] += phase_moe_prefill(lm_cfg, smi)
    moe = phase_moe_train(smi)
    for name in ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        launches[name] += moe[name]
    phase_moe_serving(lm_cfg, smi)
    phase_failed_capture(smi)

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
