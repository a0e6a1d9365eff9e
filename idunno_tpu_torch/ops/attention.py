"""Plain reference attention, ``idunno_tpu/parallel/ring_attention.py:
full_attention`` in PyTorch.

q/k/v [B, T, H, D] → [B, T, H, D]. The order of operations is the JAX
package's: the score product runs in the input dtype and only its result
is cast to f32 before the scale, the mask and the softmax; the value
product runs in f32 and the output is cast back to q's dtype. Ring
attention (the sequence-sharded variant beside it) comes with the
parallelism slice.
"""
from __future__ import annotations

import torch


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False) -> torch.Tensor:
    """Single-device reference implementation (for tests and small inputs)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if causal:
        t_q, t_k = scores.shape[-2], scores.shape[-1]
        mask = (torch.arange(t_q, device=q.device)[:, None]
                >= torch.arange(t_k, device=q.device)[None, :])
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)
