"""Language-model training step, a port of ``idunno_tpu/engine/train_lm.py``.

Next-token cross-entropy over a ``TransformerLM``, backward (through the
flash kernels K2, K4 and K5 when the model attends with ``flash`` on a
card), and one optimizer update, in place (``engine/train.py``). The MoE
auxiliary loss waits for the MoE blocks: ``aux`` is 0 for the dense
model. ``jit_lm_train_step`` has no counterpart: its mesh is slice 4.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from idunno_tpu_torch.engine.train import (TrainState, check_state,
                                           create_train_state)
from idunno_tpu_torch.models.transformer import TransformerLM

# The LM's state is made as the CNN's: ``model`` on ``device`` (``None``:
# the card), seeded with flax's initialisers (``models/init.py``) from
# ``generator``, in training mode, with its optimizer.
create_lm_train_state = create_train_state


def next_token_loss(logits: torch.Tensor,
                    tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE over [B, T] tokens (targets = tokens rolled left one,
    final position masked, so the model input keeps length T). Returns
    (ce, accuracy); accuracy carries no gradient."""
    targets = torch.roll(tokens, -1, dims=1)
    t = tokens.shape[1]
    mask = (torch.arange(t, device=tokens.device) < t - 1).to(
        torch.float32)[None, :]
    log_probs = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, -1, targets[..., None])[..., 0]
    denom = mask.sum() * tokens.shape[0]
    ce = (nll * mask).sum() / denom
    with torch.no_grad():
        acc = ((logits.argmax(-1) == targets) * mask).sum() / denom
    return ce, acc


def make_lm_train_step(model: TransformerLM,
                       optimizer: torch.optim.Optimizer,
                       aux_coef: float = 0.01, accum_steps: int = 1):
    """``step(state, tokens[int64 B, T]) -> metrics``: next-token CE plus
    ``aux_coef`` × the MoE balance loss (0 for the dense model), backward,
    one in-place update of ``model`` by ``optimizer`` (those of ``state``);
    ``state.step`` advances by one. Metrics are 0-d f32 tensors on the
    device: ``loss``, ``ce``, ``aux`` and ``accuracy``.

    ``accum_steps > 1`` is gradient accumulation: the batch is cut into
    equal chunks, run one after another, their gradients summed and
    divided by ``accum_steps``, then ONE update: for the dense model the
    same gradients as the full batch (equal chunk means) up to f32
    rounding, at 1 / ``accum_steps`` of the activation memory."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps={accum_steps}: must be >= 1")

    def loss_fn(tokens):
        ce, acc = next_token_loss(model(tokens), tokens)
        aux = torch.zeros((), device=tokens.device)
        return ce + aux_coef * aux, torch.stack([ce.detach(), aux, acc])

    def train_step(state: TrainState, tokens: torch.Tensor) -> dict:
        check_state(state, model, optimizer)
        b = tokens.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by "
                             f"accum_steps={accum_steps}")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        sums = torch.zeros(4, device=tokens.device)
        for chunk in tokens.reshape(accum_steps, b // accum_steps, -1):
            loss, parts = loss_fn(chunk)
            loss.backward()
            sums += torch.cat([loss.detach()[None], parts])
        if accum_steps > 1:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            torch._foreach_div_(grads, accum_steps)
            sums /= accum_steps
        optimizer.step()
        state.step += 1
        loss, ce, aux, acc = sums.unbind()
        return {"loss": loss, "ce": ce, "aux": aux, "accuracy": acc}

    return train_step
