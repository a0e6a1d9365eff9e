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
    card) and return their records (raises unless both exit 0 with
    one)."""
    from idunno_tpu_torch.engine.inference import resolve_device

    device = resolve_device(device).type
    addr = f"127.0.0.1:{_free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "idunno_tpu_torch.dryrun", "--coordinator",
         addr, "--num-processes", "2", "--process-id", str(i), "--device",
         device], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"process exited {p.returncode}: "
                                   f"{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="idunno_tpu_torch.dryrun")
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="virtual mesh size (data x model groups)")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the card)")
    ap.add_argument("--coordinator", help=argparse.SUPPRESS)
    ap.add_argument("--num-processes", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--process-id", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.coordinator:
        out = process_check(args.coordinator, args.num_processes,
                            args.process_id, args.device)
        print(json.dumps(out), flush=True)
        return 0 if out["ok"] else 1
    print(dryrun_multichip(args.n, args.device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
