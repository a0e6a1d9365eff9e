"""Multi-device dry run of the port, the counterpart of
``__graft_entry__.py:dryrun_multichip``.

    python -m idunno_tpu_torch.dryrun N [--device cuda|cpu]

builds a virtual mesh of N groups on one device (``--device``: the card
by default, which must be present; ``cpu`` as the tests run it;
``parallel/mesh.py:virtual_mesh``) and runs, on tiny shapes, what the port has of the JAX dry run's sections:

- the AlexNet train step over a (data, model) mesh (``n_model`` 2 with
  the large FC kernels cut when N is even, pure data parallelism
  otherwise: ``engine/train.py:shard_train_state``, ``jit_train_step``);
- the ResNet-18 engine over the same mesh, with the 7x7 stem and with the
  space-to-depth stem (``engine/inference.py:InferenceEngine(mesh=)``);
- a GQA decode pool with an int8 KV cache, its slots over the data axis
  (``engine/serve_lm.py:DecodeServer(mesh=)``);
- tensor-parallel decode token-exact against n_model 1 (greedy, seeded
  sampled, filtered, penalized and logprob rows), a vocab that does not
  divide the model axis (the head replicates), and an oversized mesh
  raising ``MeshShapeError``;
- sequence parallelism: a ring-attention LM forward over the full ring
  of N groups (vocab 128, dim 64, depth 1, 2 heads, seq 8·N:
  ``make_attn_fn("ring", mesh=)``, K2 per block pair on the card);
- pipeline parallelism: one pipelined-LM train step over N stages
  (``engine/pipeline_lm.py``), and a PP × DP step over a (2, N/2)
  (data, stage) mesh when N ≥ 4 and even;
- expert parallelism: a switch-MoE LM forward with its N experts sharded
  over an expert mesh of N (vocab 64, dim 32, depth 1, 2 heads, top-min(2,
  N), capacity factor 4, tokens (2, 8·N): ``models/moe.py:
  MoETransformerLM(mesh=)``).

The last line is ``dryrun_multichip ok: ...``; any failure raises and
exits non-zero.

`two_process_check(device)` starts two processes of this module (its
``--process-id`` mode) that join through
``parallel/mesh.py:initialize_distributed`` (gloo when they share a
card, always on the CPU) at a free local port: each checks
``process_info`` and a two-row ``global_mesh``, sums its process-local
rows across both (``parallel/data.py:from_process_local``: 4 × 1 + 4 × 2
= 12), and runs one ResNet-18 data-parallel step over the two processes
(BatchNorm over the global batch), whose loss must equal the step of one
process on the whole batch. Each prints one JSON line and exits non-zero
unless its checks passed; ``chip_smoke.py`` and the CPU tests call it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import time

import torch

def _check(ok: bool, what: str) -> None:
    """A check of the run (not an ``assert``: ``-O`` would drop it)."""
    if not ok:
        raise AssertionError(what)


def _seeded(model, seed: int, device):
    from idunno_tpu_torch.engine.train import place
    return place(model, torch.Generator(device=device).manual_seed(seed),
                 device)


def dryrun_multichip(n_devices: int, device: str | None = None) -> str:
    """The dry run over a virtual mesh of ``n_devices`` on ``device``
    (``None``: the card); returns its summary line."""
    from idunno_tpu_torch.config import EngineConfig
    from idunno_tpu_torch.engine.inference import (InferenceEngine,
                                                   resolve_device)
    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.engine.train import (TrainState, jit_train_step,
                                               sgd, shard_train_state)
    from idunno_tpu_torch.models import create_model
    from idunno_tpu_torch.models.transformer import TransformerLM
    from idunno_tpu_torch.parallel.mesh import (MeshShapeError, make_mesh,
                                                virtual_mesh)

    dev = resolve_device(device)
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_model
    mesh = virtual_mesh(n_data, n_model, dev)

    # --- training step: AlexNet (its wide FC kernels cut when n is even)
    image_size, batch = 64, 2 * n_data
    model = _seeded(create_model("alexnet"), 0, dev).train()
    state = TrainState(0, model, sgd(1e-3, momentum=0.9)(model.parameters()))
    state = shard_train_state(state, mesh, tensor_parallel=n_model > 1)
    step = jit_train_step(state.model, state.optimizer, mesh)
    images = torch.zeros((batch, 3, image_size, image_size), device=dev)
    labels = torch.zeros((batch,), dtype=torch.int64, device=dev)
    metrics = step(state, images, labels)
    loss = float(metrics["loss"])
    _check(state.step == 1 and loss == loss, f"train step {state.step}, "
           f"loss {loss}")
    del state, step, model

    # --- the engine: ResNet-18 over the same mesh, both stems
    dtype = "float32" if dev.type == "cpu" else "bfloat16"
    cfg = dict(batch_size=max(8, n_data), compute_dtype=dtype)
    eng = InferenceEngine(EngineConfig(**cfg), mesh=mesh)
    res = eng.infer("resnet", 0, 2 * n_data - 1)
    _check(len(res.records) == 2 * n_data, "engine records")
    eng_s2d = InferenceEngine(EngineConfig(stem_s2d=True, **cfg), mesh=mesh)
    res_s2d = eng_s2d.infer("resnet", 0, n_data - 1)
    _check(len(res_s2d.records) == n_data, "s2d engine records")
    del eng, eng_s2d

    sp_note = _sequence_parallel(n_devices, dev)
    pp_note = _pipeline(n_devices, dev)
    ep_note = _expert_parallel(n_devices, dev)

    # --- continuous batching: GQA + int8 KV cache, slots over the data axis
    cb_mesh = virtual_mesh(n_devices, 1, dev)
    cb_lm = _seeded(TransformerLM(vocab=64, dim=32, depth=1, num_heads=2,
                                  num_kv_heads=1, kv_cache_dtype="int8"),
                    6, dev)
    pool = DecodeServer(cb_lm, slots=n_devices, prompt_len=4, max_len=12,
                        mesh=cb_mesh)
    for i in range(n_devices + 1):        # one more than slots: reuses one
        pool.submit([1 + i, 2, 3], max_new=4)
    cb_done = pool.run_until_drained()
    _check(len(cb_done) == n_devices + 1
           and all(len(c.tokens) == 3 + 4 for c in cb_done),
           "decode pool over the data axis")
    del pool

    # --- tensor-parallel decode: token-exact against n_model 1, the odd
    # vocab's replicated head, the oversized mesh's typed refusal
    tp_note = "tp skipped (odd mesh)"
    if n_model > 1:
        tp_lm = _seeded(TransformerLM(vocab=64, dim=32, depth=2,
                                      num_heads=2), 7, dev)

        def tp_stream(nm: int):
            srv = DecodeServer(tp_lm, slots=2, prompt_len=4, max_len=16,
                               mesh=virtual_mesh(1, nm, dev),
                               penalties=True, track_logprobs=True)
            srv.submit([5, 6, 7], max_new=4)
            srv.submit([9, 8], max_new=4, temperature=0.7, seed=11)
            srv.submit([3, 1, 4], max_new=6, temperature=0.9, top_k=5,
                       top_p=0.85, seed=23)
            srv.submit([2, 6], max_new=6, presence_penalty=0.5,
                       frequency_penalty=0.3)
            done = sorted(srv.run_until_drained(), key=lambda c: c.tokens)
            return ([c.tokens for c in done],
                    [[round(lp, 4) for lp in c.logprobs] for c in done])

        tp_toks, tp_lps = tp_stream(n_model)
        ref_toks, ref_lps = tp_stream(1)
        _check(tp_toks == ref_toks, "TP decode diverged from n_model 1")
        _check(all(abs(a - b) < 1e-3 for row, ref in zip(tp_lps, ref_lps)
                   for a, b in zip(row, ref)), "TP logprobs diverged")
        odd_lm = _seeded(TransformerLM(vocab=61, dim=32, depth=2,
                                       num_heads=2), 8, dev)

        def odd_stream(nm: int):
            srv = DecodeServer(odd_lm, slots=2, prompt_len=4, max_len=12,
                               mesh=virtual_mesh(1, nm, dev))
            srv.submit([5, 6, 7], max_new=4)
            srv.submit([9, 8], max_new=4, temperature=0.7, seed=11)
            return sorted(c.tokens for c in srv.run_until_drained())

        _check(odd_stream(n_model) == odd_stream(1),
               "non-dividing-vocab TP decode diverged")
        try:
            make_mesh(n_devices, n_devices + 1,
                      devices=[dev] * n_devices, virtual=True)
            raise AssertionError("oversized mesh must raise")
        except MeshShapeError:
            pass
        tp_note = (f"tp n_model={n_model} token-exact "
                   "(sharded tail + odd-vocab degrade)")

    return (f"dryrun_multichip ok: mesh=({n_data}x{n_model}) virtual on "
            f"{dev}, train loss={loss:.4f}, inference records="
            f"{len(res.records)} (+{len(res_s2d.records)} s2d), decode "
            f"pool slots={n_devices} over {n_devices} data groups (mqa kv "
            f"+ int8 cache), {tp_note}, {sp_note}, {pp_note}, {ep_note}")


def _sequence_parallel(n_devices: int, dev) -> str:
    """The ring-attention LM forward over the full ring of ``n_devices``
    groups (the JAX section's shapes)."""
    from idunno_tpu_torch.models.transformer import (TransformerLM,
                                                     make_attn_fn)
    from idunno_tpu_torch.parallel.mesh import virtual_mesh

    sp_mesh = virtual_mesh(n_devices, 1, dev)
    lm = _seeded(TransformerLM(vocab=128, dim=64, depth=1, num_heads=2,
                               attn_fn=make_attn_fn("ring", mesh=sp_mesh)),
                 0, dev)
    seq_len = 8 * n_devices
    with torch.no_grad():
        logits = lm(torch.zeros((1, seq_len), dtype=torch.int64,
                                device=dev))
    _check(logits.shape == (1, seq_len, 128)
           and bool(torch.isfinite(logits).all()), "ring-attention LM")
    print(f"sequence parallelism: ring over {n_devices} groups, seq "
          f"{seq_len}", flush=True)
    return f"ring seq={seq_len}"


def _pipeline(n_devices: int, dev) -> str:
    """One pipelined-LM train step over ``n_devices`` stages, and a PP x DP
    step over a (2, n/2) (data, stage) mesh when n >= 4 and even."""
    from idunno_tpu_torch.engine.pipeline_lm import (
        create_pipelined_lm_train_state, jit_pipelined_lm_train_step,
        shard_pipelined_state)
    from idunno_tpu_torch.engine.train import adam
    from idunno_tpu_torch.models.transformer import TransformerLM
    from idunno_tpu_torch.parallel.mesh import STAGE_AXIS, virtual_mesh

    def one_step(n_data: int, n_stage: int, seed: int, microbatches: int,
                 data_axis):
        mesh = virtual_mesh(n_data, n_stage, dev, axis=STAGE_AXIS)
        state = create_pipelined_lm_train_state(
            TransformerLM(vocab=64, dim=32, depth=n_stage, num_heads=2),
            torch.Generator(device=dev).manual_seed(seed), adam(1e-3),
            num_stages=n_stage, device=dev)
        state = shard_pipelined_state(state, mesh)
        step = jit_pipelined_lm_train_step(state.model, state.optimizer,
                                           mesh, microbatches,
                                           data_axis=data_axis)
        loss = float(step(state, torch.zeros((4, 8), dtype=torch.int64,
                                             device=dev))["loss"])
        _check(state.step == 1 and loss == loss,
               f"pipelined step {state.step}, loss {loss}")

    one_step(1, n_devices, 4, 4, None)
    note = f"pp stages={n_devices}"
    if n_devices >= 4 and n_devices % 2 == 0:
        one_step(2, n_devices // 2, 5, 2, "data")
        note += f", pp-x-dp mesh=2x{n_devices // 2}"
    print(f"pipeline parallelism: {note}", flush=True)
    return note


def _expert_parallel(n_devices: int, dev) -> str:
    """The switch-MoE LM's forward with its experts sharded over an
    expert mesh of ``n_devices`` (the JAX section's shapes)."""
    from idunno_tpu_torch.models.moe import MoETransformerLM
    from idunno_tpu_torch.parallel.mesh import EXPERT_AXIS, virtual_mesh

    k = min(2, n_devices)
    lm = _seeded(MoETransformerLM(
        vocab=64, dim=32, depth=1, num_heads=2, n_experts=n_devices,
        capacity_factor=4.0, k=k,
        mesh=virtual_mesh(1, n_devices, dev, axis=EXPERT_AXIS)), 3, dev)
    with torch.no_grad():
        logits = lm(torch.zeros((2, 8 * n_devices), dtype=torch.int64,
                                device=dev))
    _check(logits.shape == (2, 8 * n_devices, 64)
           and bool(torch.isfinite(logits).all()), "expert-parallel LM")
    print(f"expert parallelism: {n_devices} experts over {n_devices} "
          f"shards, top-{k}", flush=True)
    return f"ep experts={n_devices} (top-{k})"


# -- two processes ------------------------------------------------------------

PROCESS_STEP = {"image": 32, "batch": 8, "lr": 0.1}


def _process_step_inputs(device):
    """The seeded ResNet-18 and batch both processes and the one-process
    reference step start from."""
    import numpy as np

    from idunno_tpu_torch.models import create_model

    model = _seeded(create_model("resnet18"), 3, device).train()
    rng = np.random.default_rng(11)
    size, b = PROCESS_STEP["image"], PROCESS_STEP["batch"]
    images = torch.from_numpy(rng.standard_normal(
        (b, 3, size, size)).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, 1000, b)).to(device)
    return model, images, labels


def _one_step(mesh, device):
    from idunno_tpu_torch.engine.train import (TrainState, jit_train_step,
                                               sgd, shard_train_state)

    model, images, labels = _process_step_inputs(device)
    state = TrainState(0, model, sgd(PROCESS_STEP["lr"], momentum=0.9)(
        model.parameters()))
    state = shard_train_state(state, mesh)
    step = jit_train_step(state.model, state.optimizer, mesh)
    loss = float(step(state, images, labels)["loss"])
    return loss, state


def process_check(coordinator: str, num_processes: int, process_id: int,
                  device: str) -> dict:
    """One process of the two-process check (module docstring)."""
    from idunno_tpu_torch.engine.inference import resolve_device
    from idunno_tpu_torch.parallel import data as data_lib
    from idunno_tpu_torch.parallel.mesh import (global_mesh,
                                                initialize_distributed,
                                                make_mesh, process_info)

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:                       # the processes share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 2)
                                  // (2 * num_processes)))
    # the one-process reference first, before the group exists
    ref_loss, ref = _one_step(make_mesh(1, 1, devices=[dev]), dev)
    ref_var = float(ref.groups[0].model.bn1.running_var.sum())
    del ref
    initialize_distributed(coordinator, num_processes=num_processes,
                           process_id=process_id,
                           local_device_ids=[0] if dev.type == "cuda"
                           else None)
    # a second call keeps the group (the JAX package's is idempotent too)
    initialize_distributed(coordinator, num_processes=num_processes,
                           process_id=process_id)
    idx, cnt = process_info()
    _check((idx, cnt) == (process_id, num_processes),
           f"process_info {(idx, cnt)}")
    mesh = global_mesh()
    _check(mesh.shape["data"] == num_processes
           and mesh.local_groups == (process_id,),
           f"global mesh {mesh.shape}, local groups {mesh.local_groups}")
    parts = data_lib.from_process_local(
        mesh, torch.full((4,), float(idx + 1), device=dev))
    total = float(data_lib.all_reduce_sum(sum(p.sum() for p in parts)))
    _check(total == 4.0 * sum(range(1, num_processes + 1)),
           f"process-local sum {total}")
    t0 = time.perf_counter()
    loss, state = _one_step(mesh, dev)
    step_s = time.perf_counter() - t0
    var = float(state.groups[0].model.bn1.running_var.sum())
    gap = abs(loss - ref_loss) / abs(ref_loss)
    var_gap = abs(var - ref_var) / abs(ref_var)
    import torch.distributed as dist
    out = {"process": idx, "processes": cnt, "backend": dist.get_backend(),
           "device": str(dev), "global_mesh": mesh.shape,
           "local_groups": list(mesh.local_groups), "process_local_sum":
           total, "loss": loss, "one_process_loss": ref_loss,
           "rel_gap": gap, "step_s": step_s, "running_var_sum": var,
           "one_process_running_var_sum": ref_var,
           "ok": gap <= 1e-5 and var_gap <= 1e-5}
    dist.barrier()
    dist.destroy_process_group()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def two_process_check(device: str | None = None, timeout: float = 300.0
                      ) -> list[dict]:
    """Start the two processes of the check on ``device`` (``None``: the
    card) and return their records (``ok`` says whether a process's
    checks held; raises where a process printed none)."""
    from idunno_tpu_torch.engine.inference import resolve_device

    device = resolve_device(device).type
    addr = f"127.0.0.1:{_free_port()}"
    return _spawn([["--coordinator", addr, "--num-processes", "2",
                    "--process-id", str(i)] for i in range(2)], device,
                  timeout)


# -- sequence, pipeline and expert parallelism across processes -------------

def cross_config(device) -> dict:
    """The shapes of `cross_process_check`: on the card the LM of
    ``utils/lm_bench.py:lm_bench_config("cuda")`` at the shapes of
    ``chip_smoke.py``'s ``seq_pipeline`` and ``expert_parallel`` phases
    (the exact sections at depth 2, the pipeline's at 4, f32 with TF32
    off; the timed steps at full depth in bf16 over f32 parameters, fused
    AdamW); on the CPU a miniature (dim 64, depth 2, 4 heads, seq 64) with
    Adam at 1e-2, as the port's CPU tests of these paths use, and no timed
    steps."""
    if torch.device(device).type == "cuda":
        from idunno_tpu_torch.utils.lm_bench import lm_bench_config

        lm = lm_bench_config("cuda")
        return {"vocab": lm["vocab"], "dim": lm["dim"], "heads": lm["heads"],
                "depth": 2, "pp_depth": 4, "batch": 2, "seq": 4096,
                "pp_batch": 8, "pp_seq": 1024, "microbatches": 8,
                "ep_tokens": [2, 1024], "n_experts": 8,
                "capacity_factor": 2.0, "steps": 3, "optimizer": "adamw",
                "lr": 3e-4, "timed_depth": lm["depth"],
                "timed_ep_tokens": [8, 1024]}
    return {"vocab": 64, "dim": 64, "heads": 4, "depth": 2, "pp_depth": 4,
            "batch": 2, "seq": 64, "pp_batch": 8, "pp_seq": 16,
            "microbatches": 4, "ep_tokens": [2, 64], "n_experts": 8,
            "capacity_factor": 2.0, "steps": 3, "optimizer": "adam",
            "lr": 1e-2, "timed_depth": 0, "timed_ep_tokens": [2, 64]}


# f32 with TF32 off: logits and losses within ``f32_rel`` (of the largest
# logit; relative), gradients within ``f32_grad_rel`` of each tensor's
# largest (``chip_smoke.py``'s SEQ/EP f32 gates), and the parameters
# after the steps within ``update_gap`` of each tensor's largest move
# (EP's: Adam moves an element by about lr a step whatever its
# gradient's size, so the rounding of the sums over processes, which
# reorders them, is amplified where a gradient is small)
CROSS_TOL = {"f32_rel": 1e-5, "f32_grad_rel": 1e-4, "update_gap": 0.1}


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def _train(step, state, tokens, n: int, params: dict) -> tuple:
    """``n`` steps: their losses, the first step's gradients (``params``:
    name → parameter) and every parameter after the steps."""
    losses = [float(step(state, tokens)["loss"])]
    grads = {k: p.grad.detach().clone() for k, p in params.items()}
    losses += [float(step(state, tokens)["loss"]) for _ in range(n - 1)]
    return losses, grads, {k: p.detach().clone() for k, p in params.items()}


def _held(got: tuple, ref: tuple, init: dict) -> dict:
    """The gaps of a cross-process run's `_train` to the in-process one's:
    losses (relative), the first gradients (over each tensor's largest)
    and the parameters after (over each tensor's largest move from
    ``init``)."""
    losses, grads, params = got
    ref_losses, ref_grads, ref_params = ref
    return {"losses": losses, "reference_losses": ref_losses,
            "loss_rel_gap": max(abs(a - b) / abs(b)
                                for a, b in zip(losses, ref_losses)),
            "grad_rel_gap": max(_rel(g, ref_grads[k])
                                for k, g in grads.items()),
            "update_gap": max(
                float((v.double() - ref_params[k].double()).abs().max()
                      / (ref_params[k].double() - init[k].double()).abs()
                      .max().clamp_min(1e-30))
                for k, v in params.items())}


def _optimizer(cfg):
    from idunno_tpu_torch.engine.train import adam, adamw, flat_tx
    if cfg["optimizer"] == "adam":
        return adam(cfg["lr"])
    return flat_tx(adamw(cfg["lr"]))


def _lm(cfg, depth, dev, attn_fn, dtype=None, routed=False, mesh=None):
    from idunno_tpu_torch.models.moe import MoETransformerLM
    from idunno_tpu_torch.models.transformer import TransformerLM

    kw = dict(vocab=cfg["vocab"], dim=cfg["dim"], depth=depth,
              num_heads=cfg["heads"], attn_fn=attn_fn, compute_dtype=dtype)
    if routed:
        return MoETransformerLM(n_experts=cfg["n_experts"], moe_every=2,
                                capacity_factor=cfg["capacity_factor"],
                                mesh=mesh, **kw).to(dev)
    return TransformerLM(**kw).to(dev)


def _weights(cfg, init, name, depth, dev, routed=False) -> dict:
    """The dense state dict a section starts from: ``init[name]`` (carried
    in by the caller) or seeded on ``dev``."""
    from idunno_tpu_torch.engine.train import place
    from idunno_tpu_torch.ops.attention import full_attention

    if init is not None:
        return {k: v.to(dev) for k, v in init[name].items()}
    model = place(_lm(cfg, depth, dev, full_attention, routed=routed),
                  torch.Generator(device=dev).manual_seed(0), dev)
    return model.state_dict()


def _tokens(cfg, shape, seed, dev):
    import numpy as np
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg["vocab"], shape)).to(dev)


class _Section:
    """The launches and the transport's counts of the cross-process runs
    of one section (each run zeroes both before and reads them after; the
    references' launches are not counted)."""

    def __init__(self) -> None:
        self.launches: dict = {}
        self.transport: dict = {}

    def run(self, fn):
        from idunno_tpu_torch.ops.launches import read_launches, zero_launches
        from idunno_tpu_torch.parallel import transport

        _sync()
        zero_launches()
        transport.COUNTS.reset()
        out = fn()
        _sync()
        for k, v in read_launches().items():
            self.launches[k] = self.launches.get(k, 0) + v
        for k, v in transport.COUNTS.as_dict().items():
            self.transport[k] = self.transport.get(k, 0) + v
        return out


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _attention_section(cfg, dev, meshes, rec, saved) -> None:
    """Ring and Ulysses attention (causal, f32) on this process's slice
    against the in-process axis: outputs equal, q/k/v gradients within
    ``f32_grad_rel`` of the largest; K2 once and K4/K5 once a live pair
    of this process's groups (the ring), once a group (Ulysses)."""
    import numpy as np

    from idunno_tpu_torch.models.transformer import auto_attention
    from idunno_tpu_torch.parallel.ring_attention import (ring_attention,
                                                          ring_pairs)
    from idunno_tpu_torch.parallel.ulysses import ulysses_attention

    b, t, h = cfg["batch"], cfg["seq"], cfg["heads"]
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, t, h, cfg["dim"] // h)).astype(np.float32)).to(dev)
        for _ in range(4))
    cells = meshes["seq"].along("data")
    lo, hi = cells.span(t)
    own_pairs = sum(1 for _, my, _, _ in ring_pairs(len(cells), True)
                    if cells.local(my))

    def run(fn, mesh, sl):
        xs = [x[:, sl].clone().requires_grad_() for x in (q, k, v)]
        out = fn(*xs, mesh, causal=True)
        out.backward(do[:, sl])
        return out.detach(), [x.grad for x in xs]

    for name, fn in (("ring", ring_attention),
                     ("ulysses", lambda *a, **kw: ulysses_attention(
                         *a, local_attn=auto_attention, **kw))):
        ref, ref_g = run(fn, meshes["seq_ref"], slice(None))
        sec = _Section()
        out, grads = sec.run(lambda: run(fn, meshes["seq"], slice(lo, hi)))
        per = own_pairs if name == "ring" else len(cells.mine)
        rec[f"{name}_attention"] = {
            "out_equal": bool(torch.equal(out, ref[:, lo:hi])),
            "grad_rel_gap": max(_rel(g, r[:, lo:hi])
                                for g, r in zip(grads, ref_g)),
            "kernel_calls_expected": per, **_counted(sec, dev)}
        saved[f"{name}_out"] = out
        saved.update({f"{name}_d{x}": g for x, g in zip("qkv", grads)})


def _pipeline_apply_section(cfg, dev, meshes, rec, saved) -> None:
    """``pipeline_apply`` of a tanh(x·w + b) stage over the stage axis
    across processes against the in-process axis: the output (sent to
    every process by the last stage's) equal."""
    import numpy as np

    from idunno_tpu_torch.parallel.pipeline import pipeline_apply

    p, d = meshes["stage"].shape["stage"], cfg["dim"]
    rng = np.random.default_rng(6)
    params = {k: torch.from_numpy((rng.standard_normal(shape) / np.sqrt(d))
                                  .astype(np.float32)).to(dev)
        for k, shape in (("w", (p, d, d)), ("b", (p, d)))}
    micro = torch.from_numpy(rng.standard_normal(
        (cfg["microbatches"], 2, d)).astype(np.float32)).to(dev)

    def stage(prm, x):
        return torch.tanh(x @ prm["w"] + prm["b"])

    with torch.no_grad():
        ref = pipeline_apply(stage, params, micro, meshes["stage_ref"])
        sec = _Section()
        out = sec.run(lambda: pipeline_apply(stage, params, micro,
                                             meshes["stage"]))
    rec["pipeline_apply"] = {"out_equal": bool(torch.equal(out, ref)),
                             "transport": sec.transport}
    saved["pipeline_apply_out"] = out


def _counted(sec: _Section, dev) -> dict:
    out = {"transport": sec.transport}
    if torch.device(dev).type == "cuda":
        out["launches"] = {k: sec.launches.get(k, 0) for k in TRAINED_NAMES}
    return out


TRAINED_NAMES = ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def _sp_section(cfg, dev, init, meshes, rec, saved, *, depth, dtype,
                steps, timed=False) -> None:
    """The sequence-parallel LM step (ring attention) over the process
    axis against the in-process axis: logits of this process's slice,
    the losses of ``steps`` steps and the parameters after them (exact
    sections); step time and launches (timed)."""
    from idunno_tpu_torch.engine.train import TrainState
    from idunno_tpu_torch.engine.train_lm import jit_lm_train_step
    from idunno_tpu_torch.models.transformer import make_attn_fn
    from idunno_tpu_torch.parallel.ring_attention import ring_pairs

    tokens = _tokens(cfg, (cfg["batch"], cfg["seq"]), 21, dev)
    sd = _weights(cfg, init, "lm", depth, dev)

    def build(mesh):
        model = _lm(cfg, depth, dev, make_attn_fn("ring", mesh=mesh), dtype)
        model.load_state_dict(sd)
        state = TrainState(0, model.train(),
                           _optimizer(cfg)(model.parameters()))
        return model, state, jit_lm_train_step(model, state.optimizer, mesh,
                                                sequence_parallel=True)

    cells = meshes["seq"].along("data")
    lo, hi = cells.span(cfg["seq"])
    key = "sp_timed" if timed else "sp_step"
    if timed:
        model, state, step = build(meshes["seq"])
        step(state, tokens)                                # warm
        sec = _Section()
        times = sec.run(lambda: _timed(step, state, tokens, steps))
        own = sum(1 for _, my, _, _ in ring_pairs(len(cells), True)
                  if cells.local(my))
        rec[key] = {"depth": depth, **times, "tokens_per_step":
                    cfg["batch"] * cfg["seq"], "kernel_calls_expected":
                    own * depth * steps, **_counted(sec, dev)}
        return
    model, state, step = build(meshes["seq_ref"])
    with torch.no_grad():
        ref_logits = model(tokens)[:, lo:hi]
    ref = _train(step, state, tokens, steps, dict(model.named_parameters()))
    del model, state, step
    model, state, step = build(meshes["seq"])
    params = dict(model.named_parameters())
    init = {k: v.detach().clone() for k, v in params.items()}
    sec = _Section()
    with torch.no_grad():
        logits = sec.run(lambda: model(tokens[:, lo:hi]))
    got = sec.run(lambda: _train(step, state, tokens, steps, params))
    rec[key] = {"depth": depth, "logits_equal": bool(torch.equal(
                    logits, ref_logits)),
                "logit_rel_gap": _rel(logits, ref_logits),
                **_held(got, ref, init), **_counted(sec, dev)}
    saved.update(sp_logits=logits, sp_losses=torch.tensor(got[0]))
    saved.update({f"sp_grad.{k}": v for k, v in got[1].items()})
    saved.update({f"sp_param.{k}": v for k, v in got[2].items()})


def _timed(step, state, tokens, n) -> dict:
    """``n`` timed steps (each ended by a synchronise): their losses, the
    median step's ms."""
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(float(step(state, tokens)["loss"]))
        _sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "step_ms": ms,
            "step_ms_median": sorted(ms)[len(ms) // 2]}


def _pp_section(cfg, dev, init, meshes, rec, saved, *, mesh_key, depth,
                dtype, steps, data_axis=None, timed=False) -> None:
    """The pipelined LM over a stage axis across processes against the
    in-process mesh: logits (the last stage's process) and loss, the
    losses of ``steps`` steps and this process's stages' parameters after
    them (exact); step time and launches (timed)."""
    from idunno_tpu_torch.engine.pipeline_lm import (
        create_pipelined_lm_train_state, jit_pipelined_lm_train_step,
        make_pipelined_lm_apply, shard_pipelined_state)
    from idunno_tpu_torch.engine.train_lm import next_token_loss
    from idunno_tpu_torch.models.transformer import make_attn_fn

    # a data row of PP x DP runs its share of the batch's microbatches
    m = cfg["microbatches"] // meshes[mesh_key].shape["data"]
    tokens = _tokens(cfg, (cfg["pp_batch"], cfg["pp_seq"]), 22, dev)
    sd = _weights(cfg, init, "pp" if depth == cfg["pp_depth"] else "lm",
                  depth, dev)
    n_stages = meshes[mesh_key].shape["stage"]

    def build(mesh):
        model = _lm(cfg, depth, dev, make_attn_fn("auto"), dtype)
        state = create_pipelined_lm_train_state(
            model, torch.Generator(device=dev), _optimizer(cfg), n_stages,
            device=dev)
        model.load_state_dict(sd)           # in place of the seeded init
        state = shard_pipelined_state(state, mesh)
        return (model, state, make_pipelined_lm_apply(model, mesh, m),
                jit_pipelined_lm_train_step(state.model, state.optimizer,
                                            mesh, m, data_axis=data_axis))

    key = (f"{mesh_key}_timed" if timed else f"{mesh_key}_step")
    mesh = meshes[mesh_key]
    if timed:
        _, state, _, step = build(mesh)
        step(state, tokens)
        sec = _Section()
        times = sec.run(lambda: _timed(step, state, tokens, steps))
        own = sum(len(g.model.stages[s]) for g in state.groups
                  for s in g.model.cells.mine)
        rec[key] = {"depth": depth, **times, "tokens_per_step":
                    cfg["pp_batch"] * cfg["pp_seq"],
                    "kernel_calls_expected": own * m * steps,
                    **_counted(sec, dev)}
        return
    _, state, apply_fn, step = build(meshes[mesh_key + "_ref"])
    with torch.no_grad():
        ref_logits = apply_fn(state.model, tokens)
    ref = _train(step, state, tokens, steps,
                 _group_params(state, meshes[mesh_key + "_ref"]))
    del state, apply_fn, step
    _, state, apply_fn, step = build(mesh)
    params = _group_params(state, mesh)
    init = {k: v.detach().clone() for k, v in params.items()}
    sec = _Section()
    with torch.no_grad():
        logits = sec.run(lambda: apply_fn(state.model, tokens))
    got = sec.run(lambda: _train(step, state, tokens, steps, params))
    out = {"depth": depth, "stages": n_stages, "microbatches": m,
           **_held(got, ref, init),
           "held_params": sorted(state.groups[0].params)[:3],
           **_counted(sec, dev)}
    if logits is not None:
        ce, _ = next_token_loss(logits, tokens)
        ref_ce, _ = next_token_loss(ref_logits, tokens)
        out.update(logits_equal=bool(torch.equal(logits, ref_logits)),
                   loss=float(ce), reference_loss=float(ref_ce))
        saved.update({f"{mesh_key}_logits": logits,
                      f"{mesh_key}_loss": ce.detach()})
    rec[key] = out


def _group_params(state, mesh) -> dict:
    """The pipelined state's parameters, keyed by data group and name
    (the groups a cross-process mesh's process runs: every row)."""
    return {f"{d}.{k}": p for g, d in zip(state.groups, mesh.local_groups)
            for k, p in g.params.items()}


def _ep_section(cfg, dev, init, meshes, rec, saved, *, depth, dtype, steps,
                tokens_shape, timed=False) -> None:
    """The routed LM (8 experts on every other block) with its experts
    over an axis across processes against the in-process axis: each
    process's rows' logits and the global loss CE + 0.01·aux, the
    routed block's ``expert_parallel_apply`` on seeded tokens and gates
    the two share; the losses of ``steps`` steps and the parameters
    after them (exact); step time and launches (timed)."""
    import numpy as np

    from idunno_tpu_torch.engine.train import TrainState
    from idunno_tpu_torch.engine.train_lm import (make_lm_train_step,
                                                  next_token_loss)
    from idunno_tpu_torch.models.convert import expert_parallel_state_dict
    from idunno_tpu_torch.models.moe import expert_ffn, moe_aux_loss
    from idunno_tpu_torch.models.transformer import make_attn_fn
    from idunno_tpu_torch.parallel import transport
    from idunno_tpu_torch.parallel.expert import expert_parallel_apply

    tokens = _tokens(cfg, tokens_shape, 23, dev)
    cells = meshes["expert"].along("expert")
    n_proc = len(set(cells.ranks))
    rows = tokens.tensor_split(n_proc)[cells.mine[0] // len(cells.mine)]
    p = len(cells)
    sd = expert_parallel_state_dict(
        _weights(cfg, init, "moe", depth, dev, routed=True), p)

    def build(mesh):
        model = _lm(cfg, depth, dev, make_attn_fn("auto"), dtype,
                    routed=True, mesh=mesh)
        own = model.state_dict()
        model.load_state_dict({k: sd[k] for k in own})
        state = TrainState(0, model.train(),
                           _optimizer(cfg)(model.parameters()))
        return model, state, make_lm_train_step(model, state.optimizer)

    def forward(model, x):
        with torch.no_grad():
            logits = model(x)
        ce, _ = next_token_loss(logits, x)
        return logits, ce, moe_aux_loss(model)

    # the layer itself on inputs the two paths share: the routed block's
    # experts over the axis, seeded tokens and gates
    rng = np.random.default_rng(24)
    n = tokens.numel()
    unit = (torch.from_numpy(rng.standard_normal((n, cfg["dim"])).astype(
                np.float32)).to(dev),
            torch.from_numpy(rng.integers(0, cfg["n_experts"], n)).to(dev),
            torch.from_numpy(rng.uniform(0.1, 1.0, n).astype(np.float32))
            .to(dev))

    def layer(model, mesh, share):
        ffn = model.blocks[1].ffn
        x, idx, w = (t.tensor_split(share[1])[share[0]] for t in unit)
        with torch.no_grad():
            return expert_parallel_apply(
                lambda prm, toks: expert_ffn(prm, toks, torch.float32),
                [s.params() for s in ffn.shards.values()], x, idx, w, mesh,
                capacity=ffn.capacity(n // p))

    key = "ep_timed" if timed else "ep_step"
    if timed:
        model, state, step = build(meshes["expert"])
        step(state, tokens)
        sec = _Section()
        times = sec.run(lambda: _timed(step, state, tokens, steps))
        rec[key] = {"depth": depth, **times, "tokens_per_step":
                    tokens.numel(), "kernel_calls_expected": depth * steps,
                    **_counted(sec, dev)}
        return
    model, state, step = build(meshes["expert_ref"])
    ref_logits, ref_ce, ref_aux = forward(model, tokens)
    ref_layer = layer(model, meshes["expert_ref"], (0, 1))
    ref = _train(step, state, tokens, steps, dict(model.named_parameters()))
    del model, state, step
    model, state, step = build(meshes["expert"])
    params = dict(model.named_parameters())
    init = {k: v.detach().clone() for k, v in params.items()}
    sec = _Section()
    logits, ce, aux = sec.run(lambda: forward(model, rows))
    share = (cells.mine[0] // len(cells.mine), n_proc)
    got_layer = sec.run(lambda: layer(model, meshes["expert"], share))
    loss = float(transport.all_reduce(ce.detach().clone())) / n_proc + \
        0.01 * float(aux)
    ref_loss = float(ref_ce) + 0.01 * float(ref_aux)
    got = sec.run(lambda: _train(step, state, tokens, steps, params))
    r0 = cells.mine[0] // len(cells.mine) * rows.shape[0]
    sl = slice(r0, r0 + rows.shape[0])
    rec[key] = {"depth": depth, "tokens": list(tokens_shape),
                "experts": cfg["n_experts"], "capacity_factor":
                cfg["capacity_factor"],
                "logits_equal": bool(torch.equal(logits, ref_logits[sl])),
                "logit_rel_gap": _rel(logits, ref_logits[sl]),
                "expert_layer_equal": bool(torch.equal(
                    got_layer, ref_layer.tensor_split(n_proc)[share[0]])),
                "loss": loss, "reference_loss": ref_loss,
                "forward_loss_rel_gap": abs(loss - ref_loss) / abs(ref_loss),
                **_held(got, ref, init), **_counted(sec, dev)}
    saved.update(ep_logits=logits, ep_loss=torch.tensor(loss))


def _gates(rec: dict, dev) -> list[str]:
    """The gates a process's record fails (`cross_process_check`)."""
    tol, failed = CROSS_TOL, []
    for name in ("ring_attention", "ulysses_attention"):
        r = rec[name]
        if not (r["out_equal"] and r["grad_rel_gap"] <= tol["f32_grad_rel"]):
            failed.append(name)
    if not rec["pipeline_apply"]["out_equal"]:
        failed.append("pipeline_apply")
    for name in ("sp_step", "stage_step", "ppdp_step", "ep_step"):
        r = rec[name]
        if not (r["loss_rel_gap"] <= tol["f32_rel"]
                and r["grad_rel_gap"] <= tol["f32_grad_rel"]
                and r["update_gap"] <= tol["update_gap"]):
            failed.append(name)
    for name in ("stage_step", "ppdp_step"):
        r = rec[name]
        if "logits_equal" in r and not (
                r["logits_equal"] and abs(r["loss"] - r["reference_loss"])
                <= tol["f32_rel"] * abs(r["reference_loss"])):
            failed.append(f"{name}_logits")
    ep = rec["ep_step"]
    if not (ep["expert_layer_equal"] and ep["logit_rel_gap"] <= tol["f32_rel"]
            and ep["forward_loss_rel_gap"] <= tol["f32_rel"]):
        failed.append("ep_forward")
    if rec["sp_step"]["logit_rel_gap"] > tol["f32_rel"]:
        failed.append("sp_logits")
    for name, r in rec.items():
        if name.endswith("_timed") and not all(
                math.isfinite(x) for x in r["losses"]):
            failed.append(f"{name}_losses")
    if torch.device(dev).type == "cuda":
        for name, r in rec.items():
            if isinstance(r, dict) and "kernel_calls_expected" in r and any(
                    r["launches"][k] != r["kernel_calls_expected"]
                    for k in TRAINED_NAMES):
                failed.append(f"{name}_launches")
    return failed


def gloo_cuda_probe(dev) -> dict:
    """Which of gloo's collectives take CUDA tensors as they are, on a
    small tensor against the same collective staged through the host:
    "equal", "differs" or the error it raised. Point-to-point is not
    probed: gloo reads its tensor's data pointer as host memory. The
    transport stages every CUDA tensor under gloo whatever this finds
    (``parallel/transport.py``); the probe records why."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.arange(4 * world, dtype=torch.float32, device=dev) + rank
    out = {}

    def host_ref(op):
        y = x.cpu()
        return op(y)

    ops = {
        "all_reduce": lambda t: (dist.all_reduce(t), t)[1],
        "broadcast": lambda t: (dist.broadcast(t, 0), t)[1],
        "all_gather": lambda t: torch.cat(
            (lambda parts: (dist.all_gather(parts, t), parts)[1])(
                [torch.empty_like(t) for _ in range(world)])),
        "all_to_all_single": lambda t: (lambda o: (
            dist.all_to_all_single(o, t), o)[1])(torch.empty_like(t))}
    for name, op in ops.items():
        want = host_ref(lambda y, op=op: op(y.clone()))
        try:
            got = op(x.clone())
        except (RuntimeError, ValueError) as e:
            out[name] = f"refused: {str(e).splitlines()[0][:160]}"
            continue
        _sync()
        out[name] = "equal" if torch.equal(got.cpu(), want) else "differs"
    return out


def cross_process_run(coordinator: str, num_processes: int, process_id: int,
                      device: str, groups: int, init: str | None = None,
                      out_dir: str | None = None) -> dict:
    """One process of `cross_process_check` (its docstring)."""
    import torch.distributed as dist

    from idunno_tpu_torch.engine.inference import resolve_device
    from idunno_tpu_torch.parallel.mesh import (EXPERT_AXIS, STAGE_AXIS,
                                                global_mesh,
                                                initialize_distributed,
                                                virtual_mesh)

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 2)
                                  // (2 * num_processes)))
    cfg = cross_config(dev)
    loaded = torch.load(init, map_location="cpu") if init else None
    t0 = time.perf_counter()
    initialize_distributed(coordinator, num_processes=num_processes,
                           process_id=process_id,
                           local_device_ids=[0] if dev.type == "cuda"
                           else None)
    devs = [dev] * groups
    p = groups * num_processes
    meshes = {
        "seq": global_mesh(devices=devs),
        "seq_ref": virtual_mesh(p, 1, dev),
        "stage": global_mesh(groups, axis=STAGE_AXIS, across=STAGE_AXIS,
                             devices=devs),
        "stage_ref": virtual_mesh(1, p, dev, axis=STAGE_AXIS),
        "ppdp": global_mesh(1, axis=STAGE_AXIS, across=STAGE_AXIS,
                            devices=devs),
        "ppdp_ref": virtual_mesh(groups, num_processes, dev,
                                 axis=STAGE_AXIS),
        "expert": global_mesh(groups, axis=EXPERT_AXIS, across=EXPERT_AXIS,
                              devices=devs),
        "expert_ref": virtual_mesh(1, p, dev, axis=EXPERT_AXIS)}
    rec: dict = {"process": process_id, "processes": num_processes,
                 "groups": groups, "backend": dist.get_backend(),
                 "device": str(dev), "axis": p, "config": cfg}
    if dev.type == "cuda" and rec["backend"] == "gloo":
        rec["gloo_cuda"] = gloo_cuda_probe(dev)
    saved: dict = {}
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exact = dict(dtype=None, steps=cfg["steps"])
    _attention_section(cfg, dev, meshes, rec, saved)
    _pipeline_apply_section(cfg, dev, meshes, rec, saved)
    _sp_section(cfg, dev, loaded, meshes, rec, saved, depth=cfg["depth"],
                **exact)
    _pp_section(cfg, dev, loaded, meshes, rec, saved, mesh_key="stage",
                depth=cfg["pp_depth"], **exact)
    _pp_section(cfg, dev, loaded, meshes, rec, saved, mesh_key="ppdp",
                depth=cfg["depth"], data_axis="data", **exact)
    _ep_section(cfg, dev, loaded, meshes, rec, saved, depth=cfg["depth"],
                tokens_shape=cfg["ep_tokens"], **exact)
    torch.backends.cuda.matmul.allow_tf32 = prev[0]
    torch.backends.cudnn.allow_tf32 = prev[1]
    rec["exact_seconds"] = time.perf_counter() - t0
    if cfg["timed_depth"]:
        t1 = time.perf_counter()
        timed = dict(depth=cfg["timed_depth"], dtype=torch.bfloat16,
                     steps=cfg["steps"], timed=True)
        _sp_section(cfg, dev, None, meshes, rec, saved, **timed)
        _pp_section(cfg, dev, None, meshes, rec, saved, mesh_key="stage",
                    **timed)
        _ep_section(cfg, dev, None, meshes, rec, saved,
                    tokens_shape=cfg["timed_ep_tokens"], **timed)
        rec["timed_seconds"] = time.perf_counter() - t1
    rec["failed"] = _gates(rec, dev)
    rec["ok"] = not rec["failed"]
    if out_dir:
        torch.save({k: v.detach().cpu() for k, v in saved.items()},
                   os.path.join(out_dir, f"process{process_id}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return rec


def _spawn(argvs: list[list[str]], device: str, timeout: float) -> list[dict]:
    """Run one ``python -m idunno_tpu_torch.dryrun`` process per argument
    list (the package on ``PYTHONPATH``) and return each one's record,
    its last line as JSON (a process whose checks failed exits 1 with
    its record, ``ok`` false); raises where a process printed none."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "idunno_tpu_torch.dryrun", *argv, "--device",
         device], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for argv in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            lines = out.strip().splitlines()
            try:
                outs.append(json.loads(lines[-1]))
            except (IndexError, json.JSONDecodeError):
                raise RuntimeError(f"process exited {p.returncode} with no "
                                   f"record: {err[-3000:]}") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def cross_process_check(device: str | None = None, processes: int = 2,
                        groups: int = 2, *, init: str | None = None,
                        out_dir: str | None = None,
                        timeout: float = 900.0) -> list[dict]:
    """Sequence, pipeline and expert parallelism over an axis of
    ``processes`` x ``groups`` positions that crosses processes: starts
    ``processes`` processes of this module (``--cross-process``) on
    ``device`` (``None``: the card, which they share, so they join over
    gloo), each with ``groups`` local groups (a virtual block of its
    device, ``parallel/mesh.py:global_mesh(devices=)``), and returns each
    process's record (``ok``: its gates held, ``failed``: those that did
    not; raises where a process printed none).

    Each process holds its runs against the same runs over the in-process
    axis (a virtual mesh of its device, the same weights and tokens), with
    TF32 off: ring and Ulysses attention (causal, f32; outputs equal,
    q/k/v gradients within ``CROSS_TOL["f32_grad_rel"]`` of the
    largest), ``pipeline_apply`` (its output on every process, equal),
    the sequence-parallel LM step (ring), the pipelined LM over
    a (1, axis) stage mesh and over a (groups, processes) (data, stage)
    mesh, and the routed LM (8 experts on every other block) over an
    expert axis: the pipeline's logits and the expert layer's output
    (``expert_parallel_apply`` on inputs the two share) equal, the other logits within ``CROSS_TOL["f32_rel"]``, the losses of
    the steps within it, the first step's gradients within
    ``f32_grad_rel`` and the parameters after the steps within
    ``update_gap``; on the card, each run's K2/K4/K5 launches as its
    process's pairs, groups and stages imply. ``cross_config`` gives the
    shapes; on the card the full-depth bf16 steps are timed. ``init``
    names a ``torch.save`` of the dense state dicts to start from (keys
    ``lm``, ``pp``, ``moe``; default: seeded), ``out_dir`` where each
    process saves its outputs (``process<i>.pt``)."""
    from idunno_tpu_torch.engine.inference import resolve_device

    device = resolve_device(device).type
    addr = f"127.0.0.1:{_free_port()}"
    extra = (["--init", init] if init else []) + \
        (["--out", out_dir] if out_dir else [])
    return _spawn([["--cross-process", "--coordinator", addr,
                    "--num-processes", str(processes), "--process-id", str(i),
                    "--groups", str(groups), *extra]
                   for i in range(processes)], device, timeout)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="idunno_tpu_torch.dryrun")
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="virtual mesh size (data x model groups)")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the card)")
    ap.add_argument("--coordinator", help=argparse.SUPPRESS)
    ap.add_argument("--num-processes", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--process-id", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--cross-process", action="store_true",
                    help="one process of cross_process_check (with "
                    "--coordinator, --num-processes, --process-id)")
    ap.add_argument("--groups", type=int, default=2,
                    help="local groups a process (--cross-process)")
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cross_process:
        out = cross_process_run(args.coordinator, args.num_processes,
                                args.process_id, args.device, args.groups,
                                args.init, args.out)
        print(json.dumps(out), flush=True)
        return 0 if out["ok"] else 1
    if args.coordinator:
        out = process_check(args.coordinator, args.num_processes,
                            args.process_id, args.device)
        print(json.dumps(out), flush=True)
        return 0 if out["ok"] else 1
    print(dryrun_multichip(args.n, args.device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
