"""Training-path bench: LM and CNN train-step throughput, a port of
``idunno_tpu/utils/train_bench.py``.

  lm    — ``engine/train_lm.py`` step on a ``TransformerLM`` with f32
          master parameters and bf16 compute, attention through the flash
          kernels forward and backward (K2, K4 and K5 on the card; their
          plain versions on the CPU; a failure is recorded, never replaced
          by the ``full`` attention), ``flat_tx(adamw(3e-4))``. Trained
          tokens/s, with MFU on the 6·params FLOPs-per-token convention
          (forward 2N + backward 4N) plus the attention term, against the
          card's bf16 dense peak.
  accum — the same step with ``accum_steps=2``.
  fsdp  — the LM step with every parameter and its optimizer moments cut
          over the data axis (``engine/train.py:fsdp_shard_train_state``,
          ZeRO-3) and the per-tensor ``adamw(3e-4)`` (a flat optimizer
          leaf is not what FSDP shards): trained tokens/s, ``vs_plain``
          against the LM point, and one data group's resident bytes
          against a replica's. Only where the mesh's data axis is larger
          than 1; absent otherwise, as in the JAX record.
  cnn   — ``engine/train.py`` step on ResNet-18, ``flat_tx(sgd(0.1,
          momentum=0.9))``, with f32 parameters and bf16 compute (the JAX
          module's default split; BatchNorm statistics in f32): images/s,
          with MFU by the JAX bench's formula, 3 × the analytic forward
          FLOPs an image (``bench.py:resnet_forward_flops``; forward +
          backward) × images/s over the card's bf16 dense peak.

Every point runs over a mesh (``parallel/mesh.py``): ``local_mesh()`` on
the card (one data group per visible card), one group on the CPU, or the
caller's; the batches are rounded up to a multiple of its data axis and
cut over its groups once, before the timed steps. A mesh of one group
runs the one-device steps (``make_lm_train_step``, ``make_train_step``),
a larger one their mesh counterparts (``jit_lm_train_step``,
``jit_train_step``: gradients summed over the groups, BatchNorm over the
global batch).

Every knob is env-overridable (``BENCH_TRAIN_*``). Only a run on the card
gives device numbers: on the CPU the record carries no MFU.
"""
from __future__ import annotations

import os
import statistics
import time

import torch

H100_BF16_FLOPS = 989e12     # H100 SXM bf16 tensor cores, dense


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def train_bench_config(platform: str) -> dict:
    """Workload sizing: ``"cuda"`` gets the full width the TPU got (the
    0.2 B-parameter LM at seq 1024, batch 8; ResNet-18 at batch 256, 224²),
    other platforms a miniature that proves the machinery, not numbers."""
    card = platform == "cuda"
    return {
        "dim": _env_int("BENCH_TRAIN_DIM", 1024 if card else 64),
        "depth": _env_int("BENCH_TRAIN_DEPTH", 12 if card else 1),
        "heads": _env_int("BENCH_TRAIN_HEADS", 16 if card else 2),
        "vocab": _env_int("BENCH_TRAIN_VOCAB", 32768 if card else 128),
        "seq": _env_int("BENCH_TRAIN_SEQ", 1024 if card else 32),
        "batch": _env_int("BENCH_TRAIN_BATCH", 8),
        "iters": _env_int("BENCH_TRAIN_ITERS", 3),
        "cnn_batch": _env_int("BENCH_TRAIN_CNN_BATCH", 256 if card else 8),
        "cnn_image": _env_int("BENCH_TRAIN_CNN_IMAGE", 224 if card else 32),
    }


def lm_flops_per_token(n_params: int, cfg: dict) -> float:
    """Forward 2N + backward 4N per token, plus the attention quadratic
    term (forward 4·T·d per layer per token, ×3 with the backward)."""
    return 6.0 * n_params + 12.0 * cfg["seq"] * cfg["dim"] * cfg["depth"]


def _timed_steps(step_fn, state, args: tuple, iters: int,
                 trace_name: str | None = None):
    """One untimed first step (it builds the kernels and warms cuBLAS),
    then ``iters`` timed steps, each ending in a read of the loss (a
    synchronize). Returns (median step s, first step s, last loss). With
    ``trace_name`` and BENCH_TRACE=1 one extra step runs after the timed
    ones under the profiler into ``.trace/<trace_name>`` at the root of
    the repository."""
    t0 = time.perf_counter()
    loss = float(step_fn(state, *args)["loss"])
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        loss = float(step_fn(state, *args)["loss"])
        times.append(time.perf_counter() - t0)
    if trace_name and os.environ.get("BENCH_TRACE") == "1":
        from idunno_tpu_torch.utils.lm_bench import trace_dir
        from idunno_tpu_torch.utils.tracing import trace
        with trace(trace_dir(trace_name)):
            float(step_fn(state, *args)["loss"])
    return statistics.median(times), first_s, loss


def _error(e: Exception) -> dict:
    return {"error": f"{type(e).__name__}: {e}"}


def _lm_model(cfg: dict) -> torch.nn.Module:
    from idunno_tpu_torch.models.transformer import (TransformerLM,
                                                     make_attn_fn)
    return TransformerLM(vocab=cfg["vocab"], dim=cfg["dim"],
                         depth=cfg["depth"], num_heads=cfg["heads"],
                         causal=True, attn_fn=make_attn_fn("flash"),
                         dtype=torch.float32, compute_dtype=torch.bfloat16)


def run_train_bench(*, device: str | torch.device | None = None,
                    mesh=None) -> dict:
    """One measured training record on ``device`` (``None``: the card,
    which must be present) over ``mesh`` (module docstring; ``None``:
    ``local_mesh()`` on the card, one group elsewhere), every model seeded
    with 0. A point that fails records its error, and an LM failure ends
    the record."""
    from idunno_tpu_torch.engine.inference import resolve_device
    from idunno_tpu_torch.engine.train import (
        adamw, create_train_state, flat_tx, fsdp_shard_train_state,
        jit_train_step, make_train_step, resident_bytes, sgd,
        shard_train_state)
    from idunno_tpu_torch.engine.train_lm import (create_lm_train_state,
                                                  jit_lm_train_step,
                                                  make_lm_train_step)
    from idunno_tpu_torch.models.resnet import resnet18
    from idunno_tpu_torch.parallel.data import shard_batch
    from idunno_tpu_torch.parallel.mesh import (DATA_AXIS, local_mesh,
                                                make_mesh)

    dev = resolve_device(mesh.lead if mesh is not None and device is None
                         else device)
    card = dev.type == "cuda"
    if mesh is None:
        mesh = local_mesh() if card else make_mesh(1, 1, devices=[dev])
    n_data = mesh.shape[DATA_AXIS]
    one = len(mesh.distinct()) == 1 and n_data == 1
    cfg = train_bench_config(dev.type)
    batch, seq = _round_up(cfg["batch"], n_data), cfg["seq"]
    out: dict = {"config": dict(cfg, batch=batch), "platform": dev.type,
                 "device_kind": (torch.cuda.get_device_name(dev) if card
                                 else "cpu"),
                 "n_devices": len(mesh.distinct()),
                 "mesh": dict(mesh.shape, virtual=mesh.virtual)}

    def placed(state):
        return state if one else shard_train_state(state, mesh)

    def lm_step(state, **kw):
        if one:
            return make_lm_train_step(state.model, state.optimizer, **kw)
        return jit_lm_train_step(state.model, state.optimizer, mesh, **kw)

    def cut(x):
        return x if one else shard_batch(mesh, x)

    # -- LM train step: flash forward and backward, no fallback -------------
    tx = flat_tx(adamw(3e-4))
    try:
        model = _lm_model(cfg)
        state = create_lm_train_state(
            model, torch.Generator(device=dev).manual_seed(0), tx,
            device=dev)
        n_params = sum(p.numel() for p in model.parameters())
        out["n_params"] = n_params
        state = placed(state)
        tokens = cut(torch.ones((batch, seq), dtype=torch.int64,
                                device=dev))
        step = lm_step(state)
        per_step, first_s, loss = _timed_steps(
            step, state, (tokens,), cfg["iters"],
            trace_name="train_lm" if card else None)
        tok_s = batch * seq / per_step
        flops_tok = lm_flops_per_token(n_params, cfg)
        out["lm"] = {
            "tokens_per_s": tok_s, "batch": batch, "seq": seq,
            "step_s": per_step, "first_step_s": first_s, "loss": loss,
            "attention": ("flash (CUDA K2 forward, K4/K5 backward)" if card
                          else "flash (plain versions on the CPU)"),
            "optimizer_layout": "fused (torch.optim.AdamW(fused=True))",
            "flash_blocks": "64x64 tiles" if card else None,
            "flops_per_token_gf": flops_tok / 1e9,
        }
        if card:
            out["lm"]["mfu"] = tok_s * flops_tok / H100_BF16_FLOPS
    except Exception as e:  # noqa: BLE001 - recorded, never a fallback
        out["lm"] = _error(e)
        return out

    # -- gradient accumulation point -----------------------------------------
    try:
        step2 = lm_step(state, accum_steps=2)
        per2, first2, _ = _timed_steps(step2, state, (tokens,),
                                       cfg["iters"])
        out["accum"] = {"accum_steps": 2,
                        "tokens_per_s": batch * seq / per2,
                        "vs_plain": per_step / per2,
                        "first_step_s": first2}
    except Exception as e:  # noqa: BLE001
        out["accum"] = _error(e)
    del state, model, step

    # -- FSDP (ZeRO-3): only where the data axis is larger than 1. The
    # per-tensor optimizer on purpose: its point is sharded moments, and
    # a flat [N] leaf shards only where N divides the axis --------------------
    if n_data > 1:
        try:
            fstate = create_lm_train_state(
                _lm_model(cfg), torch.Generator(device=dev).manual_seed(0),
                adamw(3e-4), device=dev)
            fstate = fsdp_shard_train_state(fstate, mesh)
            fstep = jit_lm_train_step(fstate.model, fstate.optimizer, mesh)
            perf, firstf, _ = _timed_steps(fstep, fstate, (tokens,),
                                           cfg["iters"])
            out["fsdp"] = {
                "tokens_per_s": batch * seq / perf,
                "vs_plain": per_step / perf, "step_s": perf,
                "first_step_s": firstf,
                "optimizer_layout":
                    "per-tensor (ZeRO-3 shards opt-state leaves)",
                "note": "vs_plain's numerator is the FUSED-optimizer "
                        "plain step (the shipped default): it folds the "
                        "per-tensor layout cost in with the sharding "
                        "cost, not a same-layout A/B",
                "resident_bytes_per_group": resident_bytes(fstate, 0),
                # a replica: each f32 parameter and its two AdamW moments
                "replicated_resident_bytes": 3 * 4 * n_params,
            }
            del fstate, fstep
        except Exception as e:  # noqa: BLE001
            out["fsdp"] = _error(e)

    # -- CNN train step (the reference's model family) -----------------------
    try:
        cb, size = _round_up(cfg["cnn_batch"], n_data), cfg["cnn_image"]
        cstate = placed(create_train_state(
            resnet18(compute_dtype=torch.bfloat16),
            torch.Generator(device=dev).manual_seed(0),
            flat_tx(sgd(0.1, momentum=0.9)), device=dev))
        images = cut(torch.zeros((cb, 3, size, size), device=dev).to(
            memory_format=torch.channels_last))
        labels = cut(torch.zeros((cb,), dtype=torch.int64, device=dev))
        cstep = (make_train_step(cstate.model, cstate.optimizer) if one
                 else jit_train_step(cstate.model, cstate.optimizer, mesh))
        perc, firstc, closs = _timed_steps(
            cstep, cstate, (images, labels), cfg["iters"],
            trace_name="train_cnn" if card else None)
        ips = cb / perc
        out["cnn"] = {
            "model": "resnet18", "images_per_s": ips,
            "batch": cb, "image_size": size, "step_s": perc,
            "first_step_s": firstc, "loss": closs,
            "dtype": "float32 parameters, bfloat16 compute",
            "compute_dtype": "bfloat16",
            "optimizer_layout": "fused (torch.optim.SGD(fused=True))",
        }
        if card:
            from idunno_tpu_torch.bench import resnet_forward_flops
            flops_img = resnet_forward_flops(size)
            out["cnn"]["flops_per_image_gf"] = flops_img / 1e9
            out["cnn"]["mfu"] = ips * 3.0 * flops_img / H100_BF16_FLOPS
    except Exception as e:  # noqa: BLE001
        out["cnn"] = _error(e)
    return out
