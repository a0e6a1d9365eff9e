"""Fine-tuning the served LM: ``make_lm_train_step`` one step after
another on seeded Markov rows.

Set-up builds one train state (the configuration's model with float32
master weights made from the seed on the card, bfloat16 compute,
attention through the flash kernels forward and backward, fused AdamW),
makes the mix's batches of distinct rows, and drives the step through its
first ``checked_steps`` steps on the first batches, keeping each step's
loss, each weight's first gradient as the optimizer holds it (its first
moment after one step over 1 - β1) and each weight's change over those
steps. The same state and step then run the window over the next batches
in turn. ``train_tokens_per_s`` is the rows × sequence of the steps run in
the window over the window, which closes once the card has finished the
last step launched before ``--seconds``.

Check: the float32 reference (``reference/train.py``) runs the same steps
from the same weights on the same rows. ``loss_gap`` is the widest
relative gap of a step's loss; ``grad_gap`` and ``update_gap`` compare,
weight by weight, the norm of the first gradient and of the change over
the checked steps: the gap between the two norms over the larger of the
reference's norm of that weight and of the median weight, the worst
weight taken. Weights whose reference gradient is under a thousandth of
the median weight's (a key's bias under softmax) move by round-off alone
and are left out of ``update_gap``.
"""
from __future__ import annotations

import statistics

import torch

from perfbench import harness, traffic
from perfbench.drivers import lm_common
from perfbench.harness import Outcome, Window


def batches(cell, seed: int, device) -> torch.Tensor:
    """[n, batch, seq] int64 Markov rows, every row distinct, from the
    seed, on the device."""
    t = cell.traffic
    rows = traffic.markov_rows(traffic.rng(seed, "markov"),
                               t["batches"] * t["batch"], t["seq"],
                               cell.config["vocab_size"])
    return torch.from_numpy(rows).view(t["batches"], t["batch"],
                                       t["seq"]).to(device)


def _norms(tensors: dict) -> dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[k].detach().float().norm() for k in names])
    return dict(zip(names, vals.double().cpu().tolist()))


def run(cell, seed: int, seconds: float, traced: bool, device,
        control: bool = False) -> Outcome:
    from idunno_tpu_torch.engine.train import TrainState, adamw, flat_tx
    from idunno_tpu_torch.engine.train_lm import make_lm_train_step

    t = cell.traffic
    opt_cfg = t["optimizer"]
    cuda = device.type == "cuda"
    model = lm_common.build_model(cell, seed, device, dtype=torch.float32,
                                  compute_dtype=torch.bfloat16,
                                  attn="flash").train()
    b1, b2 = opt_cfg["betas"]
    optimizer = flat_tx(adamw(opt_cfg["lr"], b1=b1, b2=b2, eps=opt_cfg["eps"],
                              weight_decay=opt_cfg["weight_decay"]))(
        model.parameters())
    state = TrainState(step=0, model=model, optimizer=optimizer)
    step = make_lm_train_step(model, optimizer)
    data = batches(cell, seed, device)
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    losses, grad = [], None
    for i in range(t["checked_steps"]):
        losses.append(float(step(state, data[i])["loss"]))
        if i == 0:
            grad = _norms({k: optimizer.state[p]["exp_avg"] / (1.0 - b1)
                           for k, p in params.items()
                           if "exp_avg" in optimizer.state.get(p, {})})
    change = _norms({k: params[k].detach() - start[k] for k in params})
    del start
    harness.free_device(device)
    win = Window(seconds, t["trace"], traced, cuda)
    def one() -> None:
        step(state, data[state.step % len(data)])

    win.start()
    first = state.step
    while win.tick():
        one()
    span = win.finish()
    steps = state.step - first
    win.trace_after(one)
    out = Outcome()
    out.counters["window_start"] = win.t0
    tokens = steps * t["batch"] * t["seq"]
    out.end_to_end["train_tokens_per_s"] = tokens / span
    out.counters.update(window_s=span, steps=steps, tokens=tokens,
                        seq=t["seq"], batch=t["batch"])
    out.memory_peak_bytes = harness.peak_memory(device)
    out.trace = win.trace_summary()
    out.attempted = steps
    del state, step, optimizer, params, model
    harness.free_device(device)
    program = {"loss": losses, "grad": grad, "change": change}
    readings = check(cell, seed, device, data, program, control)
    out.readings = readings
    out.compared = harness.limits_check(cell.limits, readings)
    return out


def reference_steps(cell, seed: int, device, data: torch.Tensor, *,
                    master=torch.float32, rows: slice | None = None) -> dict:
    """The reference's losses, first-gradient norms and change norms over
    the checked steps. ``master`` is the dtype its weights are held in
    between steps (the control: bfloat16, the step below the float32
    master weights the configuration states); ``rows`` keeps only those
    rows of each batch (the planted fault of a step that leaves half of
    its batch out)."""
    from perfbench.reference import common, train

    common.strict_f32()
    t, opt_cfg = cell.traffic, cell.traffic["optimizer"]
    w = lm_common.seeded(cell, seed, device, torch.float32)

    def hold() -> None:
        for v in w.values():
            v.copy_(v.to(master))

    hold()
    start = {k: v.clone() for k, v in w.items()}
    state: dict = {}
    losses, grad = [], None
    for i in range(t["checked_steps"]):
        batch = data[i] if rows is None else data[i][rows]
        loss, grads = train.loss_and_grads(w, cell.config, batch,
                                           rows=t["reference_rows"])
        losses.append(loss)
        if i == 0:
            grad = _norms(grads)
        train.adamw(w, grads, state, lr=opt_cfg["lr"],
                    betas=tuple(opt_cfg["betas"]), eps=opt_cfg["eps"],
                    weight_decay=opt_cfg["weight_decay"])
        hold()
        del grads
    change = _norms({k: w[k] - start[k] for k in w})
    del w, start, state
    harness.free_device(device)
    return {"loss": losses, "grad": grad, "change": change}


def gaps(ref: dict, got: dict) -> dict:
    """``loss_gap``, ``grad_gap`` and ``update_gap`` of ``got`` against
    ``ref`` (module docstring)."""
    med_g = statistics.median(ref["grad"].values())
    med_c = statistics.median(ref["change"].values())
    keys = list(ref["grad"])
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
    grad = max(abs(got["grad"].get(k, 0.0) - ref["grad"][k])
               / max(ref["grad"][k], med_g) for k in keys)
    moved = [k for k in keys if ref["grad"][k] >= 1e-3 * med_g]
    update = max(abs(got["change"].get(k, 0.0) - ref["change"][k])
                 / max(ref["change"][k], med_c) for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "update_gap": update,
            "left_out": len(keys) - len(moved)}


def check(cell, seed: int, device, data: torch.Tensor, program: dict,
          control: bool) -> dict:
    """The numbers of the check; with ``control`` also those of the
    reference with bfloat16 master weights (``control.*``) and of the
    half-batch fault (``fault_half.*``) against the float32 reference."""
    ref = reference_steps(cell, seed, device, data)
    out = gaps(ref, program)
    if control:
        for tag, kw in (("control", {"master": torch.bfloat16}),
                        ("fault_half", {"rows": slice(0, data.shape[1] // 2)})):
            got = reference_steps(cell, seed, device, data, **kw)
            out.update({f"{tag}.{k}": v for k, v in gaps(ref, got).items()})
    return out
