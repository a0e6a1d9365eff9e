#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``idunno_tpu_torch``) on one NVIDIA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``idunno_tpu_torch/csrc/`` with
``nvcc``, holds each against its plain PyTorch version, times it, and then
drives the port's main path: ResNet-18 and AlexNet at full width (224²
crops of 256² images, engine batch 256, seeded random weights) served by
an in-process cluster of three hosts (membership, fair scheduler,
inference service) around one engine on the card. Phases:

1. card and build: the card's name and power limit, ``-Xptxas -v``;
2. every kernel against its plain version, at the main path's shapes;
3. kernel timing with CUDA events, beside its bound and the plain time;
4. serving: concurrent ``resnet`` and ``alexnet`` queries of 1024 images
   each; every record must come back, no engine error may be reported,
   and the launch count of every kernel, zeroed just before, must rise;
5. preprocess paths on the same weights: ``kernel`` logits against
   ``plain`` and ``fold``, the card's logits against an f32 CPU reference
   on 8 images, and each path's images/s;
6. one JSON line ``{"kernels": [...]}``;
7. the last line, ``{"ok": true, "device": {...}}``.

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


def bf16_ulp(x):
    """Spacing of bf16 numbers (8 significant bits) at |x|, elementwise."""
    import torch

    _, e = torch.frexp(x.abs().to(torch.float64))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 8)


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
    cuda_build.build(["preprocess"])
    say("build", seconds=round(time.time() - t0, 3))
    print(cuda_build.ptxas_report("preprocess"), flush=True)
    return smi


def phase_kernel_vs_plain() -> float:
    """K1 against its plain version; returns the largest |difference|."""
    import torch

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
    # back-to-back launches read and write device memory
    kernel_ms = cuda_ms(lambda: preprocess_batch_kernel(x, CROP), 200)
    plain_ms = cuda_ms(lambda: preprocess_batch_plain(x, CROP), 20)
    elems = BATCH * CROP * CROP * 3
    bytes_ms = (elems * 1 + elems * 2) / HBM_BYTES_PER_S * 1e3
    ops_ms = elems * 3 / F32_FLOPS_PER_S * 1e3
    t = {"ms": kernel_ms, "plain_ms": plain_ms,
         "bound_ms": max(bytes_ms, ops_ms),
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
         "library_ms": None}
    say("timing", kernel="preprocess", batch=BATCH, **t,
        achieved_gb_per_s=(elems * 3) / (kernel_ms * 1e-3) / 1e9)
    return t


def phase_serving(engine) -> int:
    """Concurrent resnet + alexnet queries through a 3-host in-process
    cluster; returns the kernel launches the run made."""
    from idunno_tpu_torch.comm.inproc import InProcNetwork
    from idunno_tpu_torch.config import ClusterConfig
    from idunno_tpu_torch.membership.service import MembershipService
    from idunno_tpu_torch.ops.preprocess_kernel import preprocess_batch_kernel
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

    preprocess_batch_kernel.launches = 0
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
    launches = preprocess_batch_kernel.launches
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
    except ImportError as e:
        print(f"chip_smoke: the idunno_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    say("start", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda)
    smi = phase_build()
    kind = torch.cuda.get_device_name(0)
    max_abs_err = phase_kernel_vs_plain()
    timing = phase_timing()

    cfg = dict(batch_size=BATCH, image_size=CROP, resize_size=SIDE)
    engines = {mode: InferenceEngine(EngineConfig(preprocess=mode, **cfg),
                                     seed=0)
               for mode in ("kernel", "plain", "fold")}
    for name in ("resnet", "alexnet"):
        engines["kernel"].warmup(name)
    launches = phase_serving(engines["kernel"])
    phase_paths(engines, smi)

    print(json.dumps({"kernels": [{
        "name": "preprocess",
        "route": "cuda",
        "source": "idunno_tpu_torch/csrc/preprocess.cu",
        "replaces": "idunno_tpu/ops/pallas_preprocess.py:27",
        "launches": launches,
        "max_abs_err": max_abs_err,
        **timing}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
