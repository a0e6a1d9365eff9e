"""Plain float32 training step of the GPT-2-medium-shaped LM
(``perfbench/reference/gpt2.py``): next-token cross-entropy, its gradient
by autograd, and AdamW written out.

The loss is the mean over the batch and the first T-1 positions of each
row of -log softmax at the next token (the last position has no target).
AdamW follows Loshchilov and Hutter with PyTorch's placement of the
decay: p ← p·(1 - lr·wd); m ← β1·m + (1-β1)·g; v ← β2·v + (1-β2)·g²;
p ← p - lr/(1-β1ᵗ) · m / (sqrt(v/(1-β2ᵗ)) + ε). Rows go through the
forward and backward in blocks of ``rows`` so that the float32
activations fit, their gradients summed with the weight of their share
of the batch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.gpt2 import forward


def loss_and_grads(w: dict, cfg: dict, tokens: torch.Tensor, *,
                   rows: int = 2) -> tuple[float, dict[str, torch.Tensor]]:
    """(mean next-token cross-entropy, gradient of every weight) of int64
    tokens [B, T] at float32 weights ``w``."""
    b = tokens.shape[0]
    params = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    total = 0.0
    for lo in range(0, b, rows):
        chunk = tokens[lo:lo + rows]
        logits = forward(params, cfg, chunk[:, :-1])
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             chunk[:, 1:].reshape(-1))
        share = chunk.shape[0] / b
        part = torch.autograd.grad(ce * share, list(params.values()))
        for k, g in zip(params, part):
            grads[k] += g
        total += float(ce.detach()) * share
    return total, grads


def adamw(w: dict, grads: dict, state: dict, *, lr: float,
          betas: tuple[float, float], eps: float, weight_decay: float
          ) -> None:
    """One AdamW update of ``w`` in place; ``state`` holds the moments
    and the step count."""
    b1, b2 = betas
    t = state["step"] = state.get("step", 0) + 1
    for k, p in w.items():
        g = grads[k]
        m = state.setdefault("m." + k, torch.zeros_like(p))
        v = state.setdefault("v." + k, torch.zeros_like(p))
        p.mul_(1.0 - lr * weight_decay)
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v / (1.0 - b2 ** t)).sqrt_().add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1.0 - b1 ** t))
