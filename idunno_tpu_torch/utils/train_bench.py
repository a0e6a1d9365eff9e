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
  fsdp  — sharded parameters and optimizer state: slice 4; recorded as
          skipped, never as a number.
  cnn   — ``engine/train.py`` step on ResNet-18, ``flat_tx(sgd(0.1,
          momentum=0.9))``, with f32 parameters and bf16 compute (the JAX
          module's default split; BatchNorm statistics in f32): images/s,
          with MFU by the JAX bench's formula, 3 × the analytic forward
          FLOPs an image (``bench.py:resnet_forward_flops``; forward +
          backward) × images/s over the card's bf16 dense peak.

Every knob is env-overridable (``BENCH_TRAIN_*``). Only a run on the card
gives device numbers: on the CPU the record carries no MFU.
"""
from __future__ import annotations

import os
import statistics
import time

import torch

H100_BF16_FLOPS = 989e12     # H100 SXM bf16 tensor cores, dense


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


def run_train_bench(*, device: str | torch.device | None = None) -> dict:
    """One measured training record on ``device`` (``None``: the card,
    which must be present), every model seeded with 0. A point that fails
    records its error, and an LM failure ends the record."""
    from idunno_tpu_torch.engine.inference import resolve_device
    from idunno_tpu_torch.engine.train import (adamw, create_train_state,
                                               flat_tx, make_train_step, sgd)
    from idunno_tpu_torch.engine.train_lm import (create_lm_train_state,
                                                  make_lm_train_step)
    from idunno_tpu_torch.models.resnet import resnet18
    from idunno_tpu_torch.models.transformer import (TransformerLM,
                                                     make_attn_fn)

    dev = resolve_device(device)
    card = dev.type == "cuda"
    cfg = train_bench_config(dev.type)
    out: dict = {"config": cfg, "platform": dev.type,
                 "device_kind": (torch.cuda.get_device_name(dev) if card
                                 else "cpu"),
                 "n_devices": 1}

    # -- LM train step: flash forward and backward, no fallback -------------
    tx = flat_tx(adamw(3e-4))
    batch, seq = cfg["batch"], cfg["seq"]
    try:
        model = TransformerLM(vocab=cfg["vocab"], dim=cfg["dim"],
                              depth=cfg["depth"], num_heads=cfg["heads"],
                              causal=True, attn_fn=make_attn_fn("flash"),
                              dtype=torch.float32,
                              compute_dtype=torch.bfloat16)
        state = create_lm_train_state(
            model, torch.Generator(device=dev).manual_seed(0), tx,
            device=dev)
        n_params = sum(p.numel() for p in model.parameters())
        out["n_params"] = n_params
        tokens = torch.ones((batch, seq), dtype=torch.int64, device=dev)
        step = make_lm_train_step(state.model, state.optimizer)
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
        step2 = make_lm_train_step(state.model, state.optimizer,
                                   accum_steps=2)
        per2, first2, _ = _timed_steps(step2, state, (tokens,), cfg["iters"])
        out["accum"] = {"accum_steps": 2,
                        "tokens_per_s": batch * seq / per2,
                        "vs_plain": per_step / per2,
                        "first_step_s": first2}
    except Exception as e:  # noqa: BLE001
        out["accum"] = _error(e)
    del state, model, step
    out["fsdp"] = {"skipped": "slice 4"}

    # -- CNN train step (the reference's model family) -----------------------
    try:
        cb, size = cfg["cnn_batch"], cfg["cnn_image"]
        cstate = create_train_state(
            resnet18(compute_dtype=torch.bfloat16),
            torch.Generator(device=dev).manual_seed(0),
            flat_tx(sgd(0.1, momentum=0.9)), device=dev)
        images = torch.zeros((cb, 3, size, size), device=dev).to(
            memory_format=torch.channels_last)
        labels = torch.zeros((cb,), dtype=torch.int64, device=dev)
        cstep = make_train_step(cstate.model, cstate.optimizer)
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
