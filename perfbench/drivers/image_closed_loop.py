"""Bulk image classification: a closed loop of back-to-back queries
through ``InferenceEngine.infer_batch``.

Set-up: the configuration's ViT is registered with the program's model
registry under the configuration's name and loaded into an engine with
the seeded weights (made on the card in bfloat16); the mix's distinct
queries of uint8 256² images are drawn on the card from the seed and
copied once to host memory, where each query starts; one query warms
every shape. Window: query after query from host memory, each returning
its top-1 classes and probabilities. ``images_per_s`` is the images
classified over the window.

Check: every answer of the window against the float32 reference
(``reference/vit.py``) on the same images and weights: ``top1_gap``, the
widest gap by which the reference's logit of the program's class lies
below the reference's best, and ``prob_gap``, the widest relative gap of
the program's probability to the reference's probability of that class.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import harness, weights
from perfbench.harness import Outcome, Window


def _register(cell) -> str:
    from idunno_tpu_torch.models import register_model
    from idunno_tpu_torch.models.vit import ViT

    c = cell.config
    if c["mlp_ratio"] != 4:
        raise ValueError("the program's ViT block has an MLP ratio of 4")
    name = f"perfbench:{cell.config_name}"

    def factory(**kw):
        return ViT(num_classes=c["num_classes"], patch=c["patch_size"],
                   dim=c["embed_dim"], depth=c["depth"],
                   num_heads=c["num_heads"], **kw)
    register_model(name, factory)
    return name


def images(cell, seed: int, device) -> np.ndarray:
    """The mix's distinct queries [Q, N, S, S, 3] uint8, drawn on the
    device from the seed, in host memory."""
    t = cell.traffic
    size = t["stored_image_size"]
    gen = torch.Generator(device=device).manual_seed(int(seed) + 2**62)
    imgs = torch.randint(0, 256, (t["distinct_queries"], t["query_images"],
                                  size, size, 3), generator=gen,
                         device=device, dtype=torch.uint8)
    return imgs.cpu().numpy()


def run(cell, seed: int, seconds: float, traced: bool, device,
        control: bool = False) -> Outcome:
    from idunno_tpu_torch.config import EngineConfig
    from idunno_tpu_torch.engine.inference import InferenceEngine

    cfg, t = cell.config, cell.traffic
    cuda = device.type == "cuda"
    name = _register(cell)
    engine = InferenceEngine(EngineConfig(
        batch_size=t["engine_batch"], image_size=cfg["img_size"],
        resize_size=t["stored_image_size"], compute_dtype="bfloat16"),
        device=device)
    engine.load(name, weights.make(weights.vit_shapes(cfg), seed, device,
                                   torch.bfloat16))
    queries = images(cell, seed, device)
    for q in queries:
        engine.infer_batch(name, q)
    answers: list[tuple[int, np.ndarray, np.ndarray]] = []
    win = Window(seconds, t["trace"], traced, cuda)
    win.start()
    def query() -> None:
        q = len(answers) % len(queries)
        idx, prob = engine.infer_batch(name, queries[q])
        answers.append((q, idx, prob))

    while win.tick():
        query()
    span = win.finish()
    n_images = len(answers) * t["query_images"]
    win.trace_after(query)
    out = Outcome()
    out.counters["window_start"] = win.t0
    out.end_to_end["images_per_s"] = n_images / span
    out.counters.update(images=n_images, window_s=span)
    out.memory_peak_bytes = harness.peak_memory(device)
    out.trace = win.trace_summary()
    del engine
    harness.free_device(device)
    out.attempted = n_images
    readings = check(cell, seed, device, queries, answers, control)
    out.readings = readings
    out.failed = readings.pop("_failed")
    out.compared = harness.limits_check(cell.limits, readings)
    return out


@torch.no_grad()
def check(cell, seed: int, device, queries: np.ndarray, answers: list,
          control: bool) -> dict:
    """The output check's numbers over every answer of the window (module
    docstring); with ``control`` also those of the fp8 reference in the
    program's place, under ``control.<name>``."""
    from perfbench.reference import common, vit

    common.strict_f32()
    cfg = cell.config
    w = {k: v.float() for k, v in weights.make(
        weights.vit_shapes(cfg), seed, device, torch.bfloat16).items()}
    ref_logits, ctl = [], []
    for q in queries:
        parts, cparts = [], []
        for lo in range(0, len(q), 128):
            x = torch.from_numpy(q[lo:lo + 128]).to(device)
            parts.append(vit.logits(w, cfg, x))
            if control:
                cparts.append(vit.logits(w, cfg, x, fp8=True))
        ref_logits.append(torch.cat(parts))
        if control:
            ctl.append(torch.cat(cparts))
    out = {"top1_gap": 0.0, "prob_gap": 0.0, "_failed": 0}
    for qi, idx, prob in answers:
        gap, pgap, bad = _gaps(ref_logits[qi], torch.from_numpy(
            np.asarray(idx, np.int64)).to(device),
            torch.from_numpy(np.asarray(prob, np.float32)).to(device))
        out["top1_gap"] = max(out["top1_gap"], gap)
        out["prob_gap"] = max(out["prob_gap"], pgap)
        out["_failed"] += bad
    if control:
        for qi, ref in enumerate(ref_logits):
            probs = torch.softmax(ctl[qi], -1)
            top, cidx = probs.max(-1)
            gap, pgap, _ = _gaps(ref, cidx, top)
            out["control.top1_gap"] = max(out.get("control.top1_gap", 0.0),
                                          gap)
            out["control.prob_gap"] = max(out.get("control.prob_gap", 0.0),
                                          pgap)
    return out


def _gaps(ref: torch.Tensor, idx: torch.Tensor, prob: torch.Tensor
          ) -> tuple[float, float, int]:
    """(widest logit gap, widest relative probability gap, answers out of
    range) of classes ``idx`` with probabilities ``prob`` against the
    reference's logits ``ref``."""
    n = ref.shape[0]
    bad = int(((idx < 0) | (idx >= ref.shape[1])).sum()) + (len(idx) != n)
    idx = idx.clamp(0, ref.shape[1] - 1)[:n]
    mine = ref.gather(1, idx[:, None])[:, 0]
    gap = float((ref.max(-1).values - mine).max())
    p_ref = torch.softmax(ref, -1).gather(1, idx[:, None])[:, 0]
    pgap = float(((prob[:n] - p_ref).abs() / p_ref).max())
    return gap, pgap, bad
