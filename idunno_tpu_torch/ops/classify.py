"""Device-side classification heads.

The reference runs host-side ``softmax`` then ``topk(..., 1)`` per image
(`alexnet_resnet.py:80-88`). Here softmax + top-k happen on the device over
the whole batch, so only (index, probability) pairs cross to the host, as
in ``idunno_tpu/ops/classify.py``.
"""
from __future__ import annotations

import torch


def top1_from_logits(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, C] logits → ([B] int32 class ids, [B] f32 probabilities). On a
    tie the first index wins, as with ``jnp.argmax``."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    idx = torch.argmax(probs, dim=-1)
    top_prob = torch.gather(probs, -1, idx[:, None])[:, 0]
    return idx.to(torch.int32), top_prob


def topk_from_logits(logits: torch.Tensor,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, C] logits → ([B, k] int32 class ids, [B, k] f32 probabilities),
    most probable first; on a tie the lower index first, as with
    ``jax.lax.top_k``."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_prob, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return idx[:, :k].to(torch.int32), top_prob[:, :k]
